"""mlp_row_fill.train: the share of the MLP rows the train kernels computed
over the traced stretch that carried a sample: 100 x the change of the
program's `rows_valid` counter (samples_per_ray x rays, summed on the card
by every step) over that of `rows_computed` (the rung's K x rays a step,
counted on the host) between the counter snapshots that bracket the
stretch."""

from bench_h100 import spans

LAYER = "lattice, grid, compaction"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    rec = spans.program_record()
    if rec is None:
        return None
    ends = spans.bracket(ctx["prof"], rec)
    if ends is None:
        return None
    a, b = (s["counters"] for s in ends)
    computed = b["rows_computed"] - a["rows_computed"]
    if computed <= 0:
        return None
    return 100.0 * (b["rows_valid"] - a["rows_valid"]) / computed
