"""device_idle_share.train: the share of the traced steps' wall in which
no kernel ran on rank 0's device, in %: 1 - the union of the kernel
intervals over the wall (a union, since NCCL runs on a stream of its
own)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall_s)
