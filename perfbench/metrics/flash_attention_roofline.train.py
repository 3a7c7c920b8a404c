"""flash_attention_roofline.train: the attention forward kernel's share of
its roofline, in %: the summed bound of its calls over their summed
device time. A call's bound is the larger of its operations at 989
TFLOP/s and its bytes at 3.35 TB/s, counted from the function's shapes
(`work.kernels.attention_work`: causal pairs only, each input read once,
nothing saved for the backward counted); every call of a cell has the
cell's shape: (B * H) query rows of S, (B * K) kv heads of S, bf16."""

from perfbench.work.kernels import BF16_FLOPS, attention_work, bound_s

FORWARD = ("flash_wgmma_kernel", "flash_f32_kernel", "flash_decode_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    match = lambda n: any(k in n for k in FORWARD)  # noqa: E731
    calls = ctx.trace.count(match)
    if not calls:
        return None
    c, B, S = ctx.config, ctx.traffic["batch"], ctx.traffic["seq"]
    n_bytes, flops = attention_work(B * c["n_heads"], B * c["n_kv_heads"],
                                    S, S, c["head_dim"], causal=True,
                                    window=0, itemsize=2)
    return 100.0 * calls * bound_s(n_bytes, flops, BF16_FLOPS) \
        / ctx.trace.device_s(match)
