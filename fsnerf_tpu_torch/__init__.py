"""fsnerf_tpu_torch — the PyTorch + CUDA port of fsnerf_tpu, for NVIDIA Hopper.

Imports torch and numpy only; never jax, flax or fsnerf_tpu. The module
layout mirrors fsnerf_tpu so each module's counterpart is easy to find:

  cli.py          — train / render-only command line (fsnerf_tpu/cli.py)
  config.py       — config dataclasses, their YAML and the CLI's flags
                    (fsnerf_tpu/config.py)
  data/           — poses, procedural scenes, ray geometry, ray pool
  core/           — positional encoding, the NeRF nn.Module, losses,
                    LR schedules
  ops/            — sampling, occupancy grid, volume integration
  ops/kernels/    — hand-written Hopper kernels, their plain-PyTorch
                    versions and the nvcc build (sources in csrc/)
  train/          — train state, step and loop
  parallel/       — the process group (torchrun), ray-sharded training
  render/         — occgrid ray/frame/path rendering
  eval/           — PSNR / SSIM, LPIPS
  utils/interop.py — JAX params / train state and reference nn.pt -> port
  scripts/        — card-only measurements (lattice gate, step profile)

Kernel wrappers launch their CUDA kernel for CUDA tensors and run the plain
PyTorch version only for CPU tensors; there is no fallback between the two.
"""

__version__ = "0.1.0"
