"""train_mfu: the whole training step's share of the card's bf16 peak.

Model FLOPs of the measured window (2 x forward MACs x 3 per MLP row, the
rows each step's samples per ray x rays; 2 x density MACs per refreshed
cell) over the window's wall time x 989 TFLOP/s (H100 SXM, dense bf16).
"""

LAYER = "train step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_rays_per_s"
KERNELS = ()
PEAK_FLOPS = 989e12


def read(ctx):
    if ctx.get("kind") != "train" or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["window_flops"] / (ctx["window_s"] * PEAK_FLOPS)
