"""allreduce_device_ms.train: device ms a traced step in NCCL's kernels on
rank 0: the MoE layers' sums over the ranks, their cotangents' and the
optimizer's statistics."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_s(lambda n: "nccl" in n.lower()) * 1e3
    return ms / ctx.trace.steps if ms > 0 else None
