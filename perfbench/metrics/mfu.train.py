"""mfu.train: the whole step's share of the chips' peak, in %: the model
FLOPs of the traced steps (`work.flops.step_flops`: 6 a matmul weight a
token, the head and MoE's active experts only, plus attention's forward
three times; remat not counted) over their wall times the cell's chips
times 989 TFLOP/s (bf16, dense)."""

from perfbench.work.kernels import BF16_FLOPS


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    flops = ctx.step_flops * ctx.trace.steps
    return 100.0 * flops / (ctx.trace.wall_s * ctx.chips * BF16_FLOPS)
