"""flash_attention_bwd_roofline.train: the attention backward kernels'
share of their roofline, in %: the summed bound of the backward calls
(one call: a dq kernel and a dkv kernel) over their summed device time;
the bound from `work.kernels.attention_bwd_work` at the cell's shape,
bf16 (the function's own work: the forward's saved logsumexp not
counted)."""

from perfbench.work.kernels import BF16_FLOPS, attention_bwd_work, bound_s


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.count(lambda n: "attn_bwd_dq" in n)
    if not calls:
        return None
    c, B, S = ctx.config, ctx.traffic["batch"], ctx.traffic["seq"]
    n_bytes, flops = attention_bwd_work(
        B * c["n_heads"], B * c["n_kv_heads"], S, S, c["head_dim"],
        causal=True, window=0, itemsize=2)
    t = ctx.trace.device_s(lambda n: "attn_bwd_dq" in n
                           or "attn_bwd_dkv" in n)
    return 100.0 * calls * bound_s(n_bytes, flops, BF16_FLOPS) / t
