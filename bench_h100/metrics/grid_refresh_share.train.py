"""grid_refresh_share.train: the grid refresh's share of the traced
stretch's device time. Each refresh step's excess, its device time less
the median device time of the stretch's steps without a refresh at the same
K and weight-regularizer flag, summed over the refresh steps, over the
union of every device event's interval in the stretch. A step's device
time is the union of the events bench_h100/spans.py gives it."""

import statistics

from bench_h100 import spans
from bench_h100.trace import busy_us

LAYER = "grid refresh"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(ctx):
    found = spans.steps(ctx)
    if found is None:
        return None
    timed = [(a, busy_us(evs)) for a, evs in found[1]]
    plain = {}
    for a, us in timed:
        if a["refresh"] is None:
            plain.setdefault((a["k"], a["weight_reg"]), []).append(us)
    excess = 0.0
    for a, us in timed:
        if a["refresh"] is not None:
            same = plain.get((a["k"], a["weight_reg"]))
            if not same:
                return None
            excess += us - statistics.median(same)
    total = busy_us(ctx["prof"].device)
    return 100.0 * excess / total if total > 0 else None
