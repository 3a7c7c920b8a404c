"""mamba_scan_bwd_roofline.train: the scan backward kernels' share of
their roofline, in %: the summed bound of the backward calls (one call:
the reverse scan and the sum of its partials) over their summed device
time; the bound from `work.kernels.scan_bwd_work` at the cell's shape,
the cotangent of y only (the function's own work: the forward's states
and the partials the kernel writes and reads not counted), fp32."""

from perfbench.work.kernels import FP32_FLOPS, bound_s, scan_bwd_work


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.count(lambda n: "scan_bwd_kernel" in n)
    if not calls:
        return None
    c, B, S = ctx.config, ctx.traffic["batch"], ctx.traffic["seq"]
    n_bytes, flops = scan_bwd_work(B, S, c["d_inner"], c["d_state"])
    t = ctx.trace.device_s(lambda n: "scan_bwd_kernel" in n
                           or "scan_bwd_sum_kernel" in n)
    return 100.0 * calls * bound_s(n_bytes, flops, FP32_FLOPS) / t
