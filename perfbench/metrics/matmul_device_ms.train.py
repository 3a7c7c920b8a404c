"""matmul_device_ms.train: device ms a traced step in matrix products
(cuBLAS and CUTLASS kernels, by the kernel's name)."""

MATMUL = ("gemm", "nvjet", "xmma", "gemv", "cutlass")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_s(lambda n: any(k in n for k in MATMUL)) * 1e3
    return ms / ctx.trace.steps if ms > 0 else None
