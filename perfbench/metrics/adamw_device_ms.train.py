"""adamw_device_ms.train: device ms a traced step in AdamW's `_foreach`
kernels (`multi_tensor_apply` in the kernel's name)."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_s(lambda n: "multi_tensor_apply" in n) * 1e3
    return ms / ctx.trace.steps if ms > 0 else None
