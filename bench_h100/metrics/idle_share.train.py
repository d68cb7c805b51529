"""idle_share.train: the share of the traced training sub-window in which
no kernel, copy or fill ran on the card: 1 - (union of the device events'
intervals) / (the sub-window's wall time)."""

from bench_h100.trace import busy_us

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["prof"].device:
        return None
    p = ctx["prof"]
    return 100.0 * (1.0 - busy_us(p.device) / 1e6 / p.wall_s)
