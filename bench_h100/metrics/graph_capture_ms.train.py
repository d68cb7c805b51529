"""graph_capture_ms.train: the median milliseconds of one CUDA-graph
capture of a train step (train/step.py::StepGraph, whose time includes
torch.cuda.graph's synchronize, garbage collection and cache emptying on
entry) over every capture of the run: the program's `capture_s` counter."""

import statistics

from bench_h100 import spans

LAYER = "train step (ladder)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "train_rays_per_s"
KERNELS = ()


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    rec = spans.program_record()
    if rec is None or not rec["counters"].get("capture_s"):
        return None
    return 1e3 * statistics.median(rec["counters"]["capture_s"])
