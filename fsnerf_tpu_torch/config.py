"""Configuration dataclasses of the render and training paths.

Same section names, field names and defaults as fsnerf_tpu/config.py
(EncoderConfig, ModelConfig, DataConfig, SamplingConfig, TrainConfig),
without the yaml I/O and the argparse layer: the port's CLI parses its own
flags (fsnerf_tpu_torch/cli.py). Fields that only the TPU kernels or
unported features read are kept so a config built for one package names the
same things in the other; each says so where it is declared.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Positional-encoding options."""

    d_input: int = 3
    n_freqs: int = 10
    n_freqs_views: int = 4
    log_space: bool = True          # reference default: log-spaced frequencies
    no_dirs: bool = False
    # FreeNeRF annealed frequency masking: steps over which the visible band
    # grows linearly. 0 disables (identity mask).
    freq_reg_end: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """Model options."""

    model: str = "nerf"             # nerf | sinerf
    d_filter: int = 256
    n_layers: int = 8
    skip: Tuple[int, ...] = (4,)
    density_activation: str = "none"  # none | relu | trunc_exp
    # Train through the fused MLP kernels (ops/kernels/mlp_train.py for
    # NeRF, ops/kernels/siren.py for SiNeRF); None = auto: on for CUDA
    # devices (train/step.py::resolve_fused_kernel).
    fused_kernel: Optional[bool] = None
    # The NeRF train forward streams the trunk activations to device memory
    # and the backward reads them (True), or the backward recomputes the
    # trunk (False); the gradients are bitwise equal either way.
    fused_save_acts: bool = True
    # TPU tuning knobs of the JAX package's train kernels, carried but
    # unread: the port always encodes inside its kernels and fixes its own
    # tiles (fused_encode, block rows, VMEM limit, acts stride, interleave).
    fused_encode: bool = True
    fused_block_rows: Optional[int] = None
    fused_fwd_block_rows: Optional[int] = None
    fused_vmem_limit_mb: Optional[int] = None
    fused_acts_stride: Optional[int] = None
    fused_interleave: Optional[int] = None
    # SiNeRF's train forward streams the sine activations and their
    # premultiplied derivatives a cos(a y) to device memory as bf16 and the
    # backward reads them (True), or the backward recomputes the trunk and
    # holds the derivatives in float32 (False); the gradients of the two
    # modes differ by that rounding (ops/kernels/siren.py).
    siren_save_acts: bool = True
    # Render through the fused ray-march kernel (ops/kernels/render.py).
    fused_render: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Dataset options."""

    dataset: str = "synthetic"      # the port renders sphere | lattice
    scene: str = "lego"
    n_imgs: int = 100
    white_bkgd: bool = False
    factor: int = 8
    bd_factor: float = 0.75
    no_recenter: bool = False
    data_root: str = "../datasets"
    val_ratio: float = 0.15
    test_ratio: float = 0.15
    downsample: int = 1


@dataclass(frozen=True)
class SamplingConfig:
    """Ray sampling and occupancy grid."""

    strategy: str = "occgrid"       # occgrid | hierarchical
    n_samples: int = 512            # occgrid lattice, or hierarchical coarse
    n_fine: int = 128               # hierarchical inverse-CDF samples
    # compact each ray's valid samples to this many before the MLP runs;
    # the ceiling of the adaptive ladder (derive_eval_n_compact)
    n_compact: int = 192
    adapt_compact: bool = True
    compact_margin: float = 1.0
    early_stop_eps: float = 1e-4
    query_stride: int = 0           # 0 = auto (ops/occgrid.py::resolve_query_plan)
    query_dilation: Optional[int] = None
    query_max_stride: int = 0
    render_step_size: float = 5e-3
    grid_resolution: int = 128
    grid_levels: int = 1
    occ_thre: float = 1e-2
    ema_decay: float = 0.95
    update_interval: int = 16
    update_interval_late: int = 64
    update_interval_late_start: int = 1024
    warmup_steps: int = 256
    grid_hold_steps: int = -1
    update_parts: int = 4
    perturb: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training options."""

    n_iters: int = 8000
    batch_size: int = 1024
    lro: float = 5e-4
    decay_rate: float = 0.1
    Td: int = 250000                # weight-reg schedule only (T = n_iters)
    scheduler: str = "exp"          # const | exp
    seed: int = 42
    # weight regularization (alpha, active while step < reg_ratio * Td)
    ao: Optional[float] = None
    reg_ratio: float = 0.5
    reg: str = "l1"                 # l1 | l2
    # occlusion regularization; beta gates it (it does not scale it)
    occ_a: Optional[float] = None
    occ_b: Optional[float] = None
    occ_func: str = "linear"        # linear | exp
    beta: Optional[float] = None
    # compute dtype of the NeRF module (the path that does not use the fused
    # kernels, and a SiNeRF's grid refresh): float32 | bfloat16
    dtype: str = "bfloat16"
    # in-loop validation (train/loop.py): val_fn every val_rate steps
    val: bool = False
    val_rate: int = 500
    # full-state checkpoints (utils/checkpoint.py) every ckpt_every steps
    # (0 = only the final one), and continuing from the latest one
    ckpt_every: int = 0
    resume: bool = False
    # hides XLA compile time in the JAX package; the port captures a new
    # K's CUDA graphs synchronously (train/loop.py), so it is carried but
    # unread
    async_ladder: Optional[bool] = None
    # a train-PSNR collapse halts training (a non-finite loss always does)
    halt_on_divergence: bool = False


@dataclass(frozen=True)
class Config:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)
