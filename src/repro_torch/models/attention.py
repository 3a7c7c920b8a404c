"""Attention: GQA with every assigned variant, plus MLA and cross-attention.

As the reference's `repro.models.attention`, with its core softmax(QK^T)V
on one of two routes, fixed by the layer's mixer and head widths (never by
whether a launch succeeds):

  * the flash-attention kernel (`kernels.ops.mha_flash`) for every call
    its contract covers: causal, sliding-window and bidirectional masks,
    the tanh softcap, and q, k and v of one head width in
    `flash_attention.HEAD_DIMS`. On CUDA tensors it launches the kernel;
    on CPU tensors it runs the kernel's plain version,
    `ref.flash_attention_ref`. The kernel right-aligns the queries
    against the keys (qpos = i + Sk - Sq), so a cached call hands it the
    cache cut to the written keys, [:pos + Sq], which is exactly the
    reference's position mask.
  * the reference's own torch paths, dense (`_attn_dense`) and blockwise
    (`_attn_blockwise`, an online softmax over KV blocks), on both
    devices, for what the kernel does not take: chunked-local attention
    (llama4's `attn_chunked`) and MLA, whose v head width differs from
    its q/k width. The reference's Pallas kernel takes neither either.

The reference's policy-driven paths read the active sharding policy
(`sharding.act`) as the reference reads it; with no policy set each takes
its default:

  * `attn_scores_bf16`: the scores leave the QK^T product rounded to bf16
    (the softmax math stays fp32), in `_gqa_scores`;
  * `attn_remat`: the blockwise path runs under a checkpoint, so that its
    backward recomputes the per-block probabilities;
  * `attn_mode`: which dim of q the reference shards; a sharding
    constraint only, so nothing on one card;
  * `mla_absorb`: MLA's decode scores against the latent cache
    (`_mla_absorbed_decode`) instead of re-expanding it through wkv_b.

The kernel route ignores `attn_scores_bf16` and `attn_remat`: the kernel
never writes scores to memory, and its autograd Function already keeps
only q, k and v and recomputes the rest in its backward. The two knobs
change what the dense and blockwise paths compute, which MLA and
llama4's chunked attention take.
A decode cache is updated in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_dense, apply_norm, apply_rope,
                                       init_dense, init_norm, softcap)
from repro_torch.sharding import act as act_sharding

DENSE_KV_THRESHOLD = 2048   # Skv above this and Sq > 1 -> blockwise path
KV_BLOCK = 1024
KERNEL_KINDS = ("causal", "window", "bidir")
MIXER_KIND = {"attn": "causal", "attn_local": "window",
              "attn_chunked": "chunked", "attn_nope": "causal",
              "cross_attn": "bidir", "attn_bidir": "bidir"}


# ------------------------------------------------------------------ masks
def _mask_block(qpos, kpos, kind: str, window: int, chunk: int):
    """qpos: (Sq,), kpos: (Bk,) -> bool (Sq, Bk), True = attend."""
    q = qpos[:, None]
    k = kpos[None, :]
    if kind == "bidir":
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    m = k <= q  # causal
    if kind == "window":
        m = m & (k > q - window)
    elif kind == "chunked":
        m = m & (torch.div(q, chunk, rounding_mode="floor")
                 == torch.div(k, chunk, rounding_mode="floor"))
    return m


def _gqa_scores(q, k, scale, cap):
    """q: (B,Sq,K,G,hd) k: (B,Sk,K,hd) -> (B,K,G,Sq,Sk) fp32 math; with
    the policy's attn_scores_bf16, the product is rounded to bf16 as it
    leaves the matmul (the reference's preferred_element_type) and the
    softmax chain takes it back to fp32."""
    pol = act_sharding.current()
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    if pol is not None and pol.attn_scores_bf16:
        s = s.to(torch.bfloat16).float()
    return softcap(s * scale, cap)


def _attn_dense(q, k, v, qpos, kpos, kind, window, chunk, cap, scale):
    s = _gqa_scores(q, k, scale, cap)
    mask = _mask_block(qpos, kpos, kind, window, chunk)
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def _attn_blockwise(q, k, v, qpos, kpos, kind, window, chunk, cap, scale):
    """Online-softmax loop over KV blocks."""
    B, Sq, K, G, hd = q.shape
    Sk = k.shape[1]
    hdv = v.shape[-1]                       # may differ from q/k head dim (MLA)
    m = torch.full((B, K, G, Sq), -torch.inf, device=q.device)
    l = torch.zeros((B, K, G, Sq), device=q.device)
    acc = torch.zeros((B, K, G, Sq, hdv), device=q.device)
    for a in range(0, Sk, KV_BLOCK):
        kblk, vblk = k[:, a:a + KV_BLOCK], v[:, a:a + KV_BLOCK]
        s = _gqa_scores(q, kblk, scale, cap)                 # (B,K,G,Sq,Bk)
        mask = _mask_block(qpos, kpos[a:a + KV_BLOCK], kind, window, chunk)
        s = torch.where(mask[None, None, None], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))                 # may stay -inf
        m_safe = m_new.clamp_min(-1e30)                      # finite shift
        alpha = torch.exp(m - m_safe)                        # -inf-case -> 0
        p = torch.exp(s - m_safe[..., None])                 # masked -> 0
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vblk.dtype), vblk)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)            # (B,Sq,K,G,hd)


def kernel_route(kind: str, hd_qk: int, hd_v: int) -> bool:
    """Whether `mha` hands a call to the flash-attention kernel: by the
    mask kind and the head widths alone."""
    return kind in KERNEL_KINDS and hd_qk == hd_v and hd_qk in fa.HEAD_DIMS


def mha(q, k, v, *, qpos, kpos, kind="causal", window=4096, chunk=8192,
        cap=0.0, scale=None):
    """q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) with H % K == 0. Returns
    (B,Sq,H,hdv). On the kernel route (`kernel_route`) the positions must
    be right-aligned, qpos = kpos[Sk - Sq:] and kpos = arange(Sk), or any
    positions under a bidirectional mask: every caller in this package
    passes them so."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = (hd ** -0.5) if scale is None else scale
    if kernel_route(kind, hd, v.shape[-1]):
        return ops.mha_flash(q, k, v, causal=kind != "bidir",
                             window=window if kind == "window" else 0,
                             softcap=cap, scale=scale)
    qg = q.reshape(B, Sq, K, G, hd)
    if Sq == 1 or k.shape[1] <= DENSE_KV_THRESHOLD:
        out = _attn_dense(qg, k, v, qpos, kpos, kind, window, chunk, cap,
                          scale)
    else:
        args = (qg, k, v, qpos, kpos, kind, window, chunk, cap, scale)
        pol = act_sharding.current()
        if pol is not None and pol.attn_remat and torch.is_grad_enabled():
            # flash-backward semantics: recompute the probabilities in the
            # backward instead of keeping each block's p and alpha
            out = checkpoint(_attn_blockwise, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = _attn_blockwise(*args)
    return out.reshape(B, Sq, H, v.shape[-1])   # v head dim may differ (MLA)


# ------------------------------------------------------------------ GQA module
def init_attention(gen, cfg, spec, *, lead=(), device):
    H, K, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    kw = dict(lead=lead, device=device)
    p = {}
    p.update(init_dense(gen, D, H * hd, cfg.pdtype, bias=cfg.qkv_bias,
                        name="wq", **kw))
    p.update(init_dense(gen, D, K * hd, cfg.pdtype, bias=cfg.qkv_bias,
                        name="wk", **kw))
    p.update(init_dense(gen, D, K * hd, cfg.pdtype, bias=cfg.qkv_bias,
                        name="wv", **kw))
    p.update(init_dense(gen, H * hd, D, cfg.pdtype, name="wo", **kw))
    if cfg.qk_norm:
        p["qnorm"] = init_norm((*lead, hd), "rmsnorm", cfg.pdtype,
                               device=device)
        p["knorm"] = init_norm((*lead, hd), "rmsnorm", cfg.pdtype,
                               device=device)
    if spec.mixer == "cross_attn" and cfg.family == "vlm":
        # tanh-gated cross-attn (llama-vision)
        p["xgate"] = torch.zeros(lead, dtype=cfg.pdtype, device=device)
    return p


def _project_kv(p, src, cfg):
    B, S = src.shape[:2]
    K, hd = cfg.n_kv_heads, cfg.hd
    k = apply_dense(p, src, "wk", cfg.cdtype).reshape(B, S, K, hd)
    v = apply_dense(p, src, "wv", cfg.cdtype).reshape(B, S, K, hd)
    if cfg.qk_norm:
        k = apply_norm(p["knorm"], k, "rmsnorm")
    return k, v


def _append(cache, names, new, Sq):
    """Write `new` (B, Sq, ...) tensors at the cache's write head, advance
    it, and return the cache's written prefixes [:pos + Sq] and pos."""
    idx = int(cache["pos"])
    out = []
    for name, t in zip(names, new):
        cache[name][:, idx:idx + Sq] = t
        out.append(cache[name][:, :idx + Sq])
    cache["pos"].fill_(idx + Sq)
    return out, idx


def apply_attention(p, x, cfg, spec, *, positions, cache=None, memory=None):
    """Self/cross attention.

    cache: None (no cache) or, for decode and cached prefill, a dict with
      {"k": (B,Smax,K,hd), "v": ..., "pos": host int32 scalar tensor},
      updated in place; for cross_attn {"ck", "cv"} (B,M,K,hd).
    memory: (B,M,D) for cross_attn.
    Returns out (B,Sq,D).
    """
    B, Sq, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = apply_dense(p, x, "wq", cfg.cdtype).reshape(B, Sq, H, hd)
    if cfg.qk_norm:
        q = apply_norm(p["qnorm"], q, "rmsnorm")

    kind = MIXER_KIND[spec.mixer]
    use_rope = cfg.use_rope and spec.mixer in ("attn", "attn_local",
                                               "attn_chunked")

    if spec.mixer == "cross_attn":
        if memory is not None:                        # prefill: project now
            k, v = _project_kv(p, memory, cfg)
            if cache is not None:
                cache["ck"].copy_(k)
                cache["cv"].copy_(v)
        else:                                         # decode: pre-projected
            k, v = cache["ck"].to(q.dtype), cache["cv"].to(q.dtype)
        kpos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        out = mha(q, k, v, qpos=positions, kpos=kpos, kind="bidir",
                  cap=cfg.attn_logit_softcap)
        if "xgate" in p:
            out = torch.tanh(p["xgate"].float()).to(out.dtype) * out
    else:
        k, v = _project_kv(p, x, cfg)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:                          # append to cache
            (k, v), idx = _append(cache, ("k", "v"), (k, v), Sq)
            k, v = k.to(q.dtype), v.to(q.dtype)
            kpos = torch.arange(idx + Sq, dtype=torch.int32, device=x.device)
        else:
            kpos = positions
        out = mha(q, k, v, qpos=positions, kpos=kpos, kind=kind,
                  window=cfg.window, chunk=cfg.chunk,
                  cap=cfg.attn_logit_softcap)

    out = out.reshape(B, Sq, H * hd)
    return apply_dense(p, out, "wo", cfg.cdtype)


# ------------------------------------------------------------------ MLA
def init_mla(gen, cfg, *, lead=(), device):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(lead=lead, device=device)
    p = {}
    p.update(init_dense(gen, D, m.q_lora_rank, cfg.pdtype, name="wq_a", **kw))
    p["q_a_norm"] = init_norm((*lead, m.q_lora_rank), "rmsnorm", cfg.pdtype,
                              device=device)
    p.update(init_dense(gen, m.q_lora_rank, H * qk_dim, cfg.pdtype,
                        name="wq_b", **kw))
    p.update(init_dense(gen, D, m.kv_lora_rank + m.qk_rope_head_dim,
                        cfg.pdtype, name="wkv_a", **kw))
    p["kv_a_norm"] = init_norm((*lead, m.kv_lora_rank), "rmsnorm", cfg.pdtype,
                               device=device)
    p.update(init_dense(gen, m.kv_lora_rank,
                        H * (m.qk_nope_head_dim + m.v_head_dim), cfg.pdtype,
                        name="wkv_b", **kw))
    p.update(init_dense(gen, H * m.v_head_dim, D, cfg.pdtype, name="wo",
                        **kw))
    return p


def apply_mla(p, x, cfg, *, positions, cache=None):
    """Multi-head latent attention. The *latent* (kv_lora + rope-k) is
    what the decode cache holds; a cache is updated in place. A decode
    step under the policy's `mla_absorb` takes `_mla_absorbed_decode`.
    Returns out (B,Sq,D)."""
    m = cfg.mla
    B, Sq, D = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    qa = apply_dense(p, x, "wq_a", cfg.cdtype)
    qa = apply_norm(p["q_a_norm"], qa, "rmsnorm")
    q = apply_dense(p, qa, "wq_b", cfg.cdtype).reshape(B, Sq, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = apply_dense(p, x, "wkv_a", cfg.cdtype)
    c_kv, k_rope = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        (c_kv, k_rope), idx = _append(cache, ("ckv", "krope"),
                                      (c_kv, k_rope), Sq)
        pol = act_sharding.current()
        if Sq == 1 and pol is not None and pol.mla_absorb:
            return _mla_absorbed_decode(p, m, q_nope, q_rope, c_kv, k_rope,
                                        cfg)
        c_kv, k_rope = c_kv.to(x.dtype), k_rope.to(x.dtype)
        kpos = torch.arange(idx + Sq, dtype=torch.int32, device=x.device)
    else:
        kpos = positions

    c_kv = apply_norm(p["kv_a_norm"], c_kv, "rmsnorm")
    kv = apply_dense(p, c_kv, "wkv_b", cfg.cdtype)
    Sk = kv.shape[1]
    kv = kv.reshape(B, Sk, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sk, H, rope_d)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)

    out = mha(qfull, k, v, qpos=positions, kpos=kpos, kind="causal",
              scale=(nope + rope_d) ** -0.5)
    out = out.reshape(B, Sq, H * vd)
    return apply_dense(p, out, "wo", cfg.cdtype)


def _mla_absorbed_decode(p, mm, q_nope, q_rope, c_all, kr_all, cfg):
    """MLA decode with absorbed projections, as the reference's.

    The naive decode path re-expands the whole latent cache through wkv_b
    every step: O(S * r * H * (nope+v)) FLOPs per token per layer. Scoring
    against the LATENT instead (fold wkv_b's key half into the query, its
    value half into the output) costs O(S * H * r), and the (B,S,H,nope+v)
    expanded cache never exists. c_all/kr_all are the cache's written
    prefixes [:pos + 1] (the reference masks the rest to -1e30, whose
    exp is 0). Returns out (B,1,D).
    """
    B, _, H, nope = q_nope.shape
    r = mm.kv_lora_rank
    vd = mm.v_head_dim
    wkv_b = p["wkv_b"].to(cfg.cdtype).reshape(r, H, nope + vd)
    wk = wkv_b[..., :nope]                              # (r, H, nope)
    wv = wkv_b[..., nope:]                              # (r, H, vd)
    c_n = apply_norm(p["kv_a_norm"], c_all.to(cfg.cdtype), "rmsnorm")
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(),
                         wk.float())                    # absorb k-half
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_n.float())
         + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), kr_all.float()))
    s = s * ((nope + mm.qk_rope_head_dim) ** -0.5)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", pr, c_n.float())
    out = torch.einsum("bqhr,rhv->bqhv", ctx, wv.float())
    out = out.reshape(B, 1, H * vd).to(cfg.cdtype)
    return apply_dense(p, out, "wo", cfg.cdtype)
