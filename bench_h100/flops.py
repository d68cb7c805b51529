"""Model FLOPs: the work the algorithm needs, whatever implements it.

Multiply-adds of one row at the configuration's unpadded widths (frozen
copies of the port's card script's `mlp_macs`, `density_macs` and
`siren_macs`), and the grid refresh's schedule (a frozen copy of the
sampler's `update_interval` / `warmup_steps` / `update_parts` rules). A
trained row costs 2 x forward MACs x 3 (the forward and the backward's two
products); a refreshed cell 2 x density MACs.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12          # H100 SXM, dense bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3


def _enc(n_freqs: int) -> int:
    return 3 * (1 + 2 * n_freqs)


def nerf_density_macs(cfg: dict) -> int:
    m = cfg["model"]
    L, W, skip = m["n_layers"], m["d_filter"], tuple(m["skip"])
    de = _enc(cfg["encoder"]["n_freqs"])
    return de * W + sum(W * W + (de * W if (i - 1) in skip else 0)
                        for i in range(1, L)) + W


def nerf_macs(cfg: dict) -> int:
    W = cfg["model"]["d_filter"]
    dd = _enc(cfg["encoder"]["n_freqs_views"])
    return nerf_density_macs(cfg) + W * W + (W + dd) * (W // 2) + \
        (W // 2) * 3


def siren_density_macs(cfg: dict) -> int:
    L, W = cfg["model"]["n_layers"], cfg["model"]["d_filter"]
    Wh = W // 2
    return 3 * W + (L - 1) * W * W + W * Wh + Wh


def siren_macs(cfg: dict) -> int:
    L, W = cfg["model"]["n_layers"], cfg["model"]["d_filter"]
    Wh = W // 2
    return 3 * W + (L - 1) * W * W + W * Wh + Wh + W * W + (W + 3) * Wh + \
        Wh * 3


def forward_macs(cfg: dict) -> int:
    return siren_macs(cfg) if cfg["reference"] == "sinerf" else \
        nerf_macs(cfg)


def density_macs(cfg: dict) -> int:
    return siren_density_macs(cfg) if cfg["reference"] == "sinerf" else \
        nerf_density_macs(cfg)


def train_row_flops(cfg: dict) -> int:
    return 2 * forward_macs(cfg) * 3


def refreshed_cells(cfg: dict, step: int) -> int:
    """Cells the grid refresh after step `step` evaluates (0: none)."""
    s = cfg["sampling"]
    late = s["update_interval_late"]
    interval = (late if late and step >= s["update_interval_late_start"]
                else s["update_interval"])
    if step % interval:
        return 0
    cells = s["grid_resolution"] ** 3 * s["grid_levels"]
    return cells if step < s["warmup_steps"] else cells // s["update_parts"]


def refresh_flops(cfg: dict, first: int, last: int) -> int:
    """FLOPs of the refreshes after steps first .. last - 1."""
    return 2 * density_macs(cfg) * sum(refreshed_cells(cfg, k)
                                       for k in range(first, last))


def n_params(cfg: dict) -> int:
    """Parameters of the MLP (weights and biases)."""
    m = cfg["model"]
    L, W = m["n_layers"], m["d_filter"]
    if cfg["reference"] == "sinerf":
        Wh = W // 2
        return (3 * W + W) + (L - 1) * (W * W + W) + (W * Wh + Wh) + \
            (Wh + 1) + (W * W + W) + ((W + 3) * Wh + Wh) + (Wh * 3 + 3)
    de = _enc(cfg["encoder"]["n_freqs"])
    dd = _enc(cfg["encoder"]["n_freqs_views"])
    skip = tuple(m["skip"])
    trunk = de * W + W + sum(W * W + W + (de * W if (i - 1) in skip else 0)
                             for i in range(1, L))
    fan = W + (de if (L - 1) in skip else 0)
    return trunk + (fan + 1) + (fan * W + W) + ((W + dd) * (W // 2) +
                                                W // 2) + ((W // 2) * 3 + 3)
