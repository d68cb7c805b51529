"""The benchmark of fsnerf_tpu_torch on one NVIDIA H100: BENCHMARK.json at
the repository root names its cells; `python3 -m bench_h100.run` runs one."""
