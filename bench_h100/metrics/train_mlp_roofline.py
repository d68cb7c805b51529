"""train_mlp_roofline: the train MLP kernels' share of their roofline over
the traced sub-window.

The bound of the rows the sub-window's steps trained: the larger of their
model FLOPs over 989 TFLOP/s and their bytes (each row's inputs and
outputs, and each step's weights and weight gradients once) over
3.35 TB/s; divided by the summed device time of the kernels named below
(the NeRF train forward and row pass, the SIREN forward and row pass, the
shared weight-gradient pass and its reduction).
"""

LAYER = "train MLP kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
KERNELS = ("mlp_train_fwd_kernel", "mlp_train_bwd_rows_kernel",
           "siren_fwd_", "siren_bwd_rows", "dw_gemm_kernel",
           "dw_reduce_kernel")
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    us = ctx["prof"].kernel_us(KERNELS)
    if us <= 0:
        return None
    bound_s = max(ctx["rows"] * ctx["row_flops"] / PEAK_FLOPS,
                  ctx["bytes"] / PEAK_BYTES)
    return 100.0 * bound_s / (us * 1e-6)
