"""mamba_scan_roofline.train: the scan forward kernel's share of its
roofline, in %: the summed bound of its calls over their summed device
time; a call's bound from `work.kernels.scan_work` at the cell's shape,
x (B, S, d_inner), N states, the skip term, no h0 (the function's own
work: the chunk states kept for the backward not counted), fp32 at 67
TFLOP/s or 3.35 TB/s."""

from perfbench.work.kernels import FP32_FLOPS, bound_s, scan_work


def read(ctx):
    if ctx.trace is None:
        return None
    match = lambda n: "mamba_scan_kernel" in n  # noqa: E731
    calls = ctx.trace.count(match)
    if not calls:
        return None
    c, B, S = ctx.config, ctx.traffic["batch"], ctx.traffic["seq"]
    n_bytes, flops = scan_work(B, S, c["d_inner"], c["d_state"])
    return 100.0 * calls * bound_s(n_bytes, flops, FP32_FLOPS) \
        / ctx.trace.device_s(match)
