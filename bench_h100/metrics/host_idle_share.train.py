"""host_idle_share.train: the idle time of the card that falls outside
every training step's device extent (its first device event to its last,
bench_h100/spans.py), over the traced stretch's wall time: the idle the
host causes between steps. idle_share.train less this is the idle inside
the steps (between the kernels of a replay)."""

from bench_h100 import spans
from bench_h100.trace import busy_us

LAYER = "train step (host)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(ctx):
    found = spans.steps(ctx)
    if found is None:
        return None
    p = ctx["prof"]
    wall_us = p.wall_s * 1e6
    extents = spans.union(
        (min(e["ts"] for e in evs), max(e["ts"] + e["dur"] for e in evs))
        for _, evs in found[1])
    inside = sum((b - a) - spans.busy_within(p.device, a, b)
                 for a, b in extents)
    idle = wall_us - busy_us(p.device)
    return 100.0 * (idle - inside) / wall_us
