"""Training: state, step and loop (port of fsnerf_tpu/train)."""
