"""Top-level language models: embedding -> superblock stack -> head.

The reference's functional API (`repro.models.lm`):

  init_params(gen, cfg, device=...)        -> params tree (dict of tensors)
  forward(params, tokens, cfg, ...)        -> (logits, cache, aux)
  loss_fn(params, batch, cfg)              -> (scalar, metrics)
  init_cache(cfg, batch, max_len, device)  -> decode cache tree (stacked per
                                              superblock)
  prefill(params, tokens, cfg, max_len)    -> (logits_last, cache)
  decode_step(params, token, cache, cfg, pos) -> (logits, cache)
  serving_params(params, cfg)              -> the serving copy (below)

Enc-dec (whisper): `encode(params, frames, cfg)` produces the encoder
memory that the decoder's cross-attn layers consume (the mel/conv frontend
is a stub: `frames` are precomputed frame embeddings). VLM
(llama-3.2-vision): cross-attn layers consume precomputed patch embeddings
passed as `memory`.

The loss is next-token cross-entropy in fp32 over chunks of CE_CHUNK
tokens, each chunk under a checkpoint, so that a chunk's (tokens, vocab)
logits live only while it is computed and again in its backward. As in
the reference, the active sharding policy's `ce_chunk`, when set, takes
the place of CE_CHUNK (`sharding.act`).

A cache is updated in place: `prefill` and `decode_step` return the cache
they wrote. Its attention write heads ("pos") are host tensors, so that a
step reads them without waiting on the card.

The serving copy: the reference keeps its parameters in `param_dtype` and
casts each matrix to `compute_dtype` at every use. `serving_params` makes
that cast once, for exactly the tensors the reference casts at use
(`SERVING_CAST`: every dense weight and its bias, the Mamba conv, the
expert weights, the embedding, the head and the learned positions); norm
scales and biases, the router, the cross-attn gate, `mamba_A_log` and
`mamba_D` stay as they are. The model computes the same values from
either copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.common import (apply_norm, init_norm, normal_init,
                                       scaled, softcap)
from repro_torch.sharding import act as act_sharding

# leaf names the reference casts to cfg.cdtype wherever it reads them
SERVING_CAST = frozenset({
    "wq", "wk", "wv", "wo", "wq_bias", "wk_bias", "wv_bias",
    "wq_a", "wq_b", "wkv_a", "wkv_b",
    "w_gate", "w_up", "w_down", "moe_wg", "moe_wu", "moe_wd",
    "mamba_in", "mamba_xproj", "mamba_dtproj", "mamba_dtproj_bias",
    "mamba_out", "mamba_conv_w", "mamba_conv_b",
    "embed", "lm_head", "pos_embed"})


# ------------------------------------------------------------------ init
def init_params(gen, cfg, *, device):
    """Seeded parameters from the generator `gen` (None on "meta")."""
    kw = dict(device=device)
    p = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdtype,
                             **kw),
        "stack": blocks.init_stack(gen, cfg, **kw),
        "final_norm": init_norm((cfg.d_model,), cfg.norm, cfg.pdtype, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size),
                                   cfg.pdtype, **kw)
    if cfg.learned_pos_emb:
        p["pos_embed"] = normal_init(gen, (cfg.max_decoder_len, cfg.d_model),
                                     cfg.pdtype, **kw)
    if cfg.encoder is not None:
        enc_cfg = cfg.encoder_cfg()
        p["encoder"] = {
            "stack": blocks.init_stack(gen, enc_cfg, **kw),
            "final_norm": init_norm((cfg.d_model,), cfg.norm, cfg.pdtype,
                                    **kw),
            "pos_embed": normal_init(gen, (cfg.encoder.n_frames, cfg.d_model),
                                     cfg.pdtype, **kw),
        }
    return p


def serving_params(params, cfg):
    """The serving copy: each leaf named in `SERVING_CAST` cast to
    cfg.cdtype (a new tensor), every other leaf the same tensor."""
    return {k: serving_params(v, cfg) if isinstance(v, dict)
            else v.to(cfg.cdtype) if k in SERVING_CAST else v
            for k, v in params.items()}


# ------------------------------------------------------------------ encoder
def encode(params, frames, cfg):
    """frames: (B, n_frames, d_model) precomputed frame/patch embeddings
    (stub frontend). Returns encoder memory (B, n_frames, d_model)."""
    enc_cfg = cfg.encoder_cfg()
    ep = params["encoder"]
    x = frames.to(cfg.cdtype) + ep["pos_embed"].to(cfg.cdtype)[None]
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    x, _ = blocks.apply_stack(ep["stack"], x, enc_cfg, positions=pos)
    return apply_norm(ep["final_norm"], x, cfg.norm)


# ------------------------------------------------------------------ forward
def _embed(params, tokens, cfg):
    x = params["embed"][tokens].to(cfg.cdtype)
    return scaled(x, cfg.scale_emb)


def _head(params, x, cfg):
    xn = apply_norm(params["final_norm"], x, cfg.norm,
                    unit_offset=cfg.name.startswith("gemma"))
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(cfg.cdtype)
    logits = xn.to(cfg.cdtype) @ w
    return softcap(logits.float(), cfg.final_logit_softcap)


def forward(params, tokens, cfg, *, positions=None, cache=None, memory=None,
            remat=True, head="full"):
    """tokens: (B, S) int. memory: (B, M, D) for cross-attn archs.
    head: "full" -> logits (B,S,V); "last" -> (B,1,V); "none" -> hidden.
    remat: checkpoint each superblock when gradients are on.
    Returns (logits_or_hidden fp32, the cache given (updated) or None,
    aux scalar)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed(params, tokens, cfg)
    if cfg.learned_pos_emb:
        x = x + params["pos_embed"][positions].to(cfg.cdtype)
    x, aux = blocks.apply_stack(params["stack"], x, cfg, positions=positions,
                                cache=cache, memory=memory, remat=remat)
    if head == "none":
        return x, cache, aux
    if head == "last":
        x = x[:, -1:]
    return _head(params, x, cfg), cache, aux


# ------------------------------------------------------------------ loss
CE_CHUNK = 65536    # tokens per CE chunk: logits are never materialized for
                    # more than this many rows (chunked cross-entropy)


def _ce_chunk(carry, xb, tb, mb, w, cap):
    """One chunk's summed NLL and mask added to carry (s, m)."""
    lg = softcap((xb @ w).float(), cap)
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tb[:, None])[:, 0]
    s, m = carry
    return s + torch.sum((lse - gold) * mb), m + torch.sum(mb)


def _ce_chunked(params, x, targets, mask, cfg):
    """x: (B,S,D) hidden; targets/mask: (B,S). Computes sum-NLL/sum-mask
    a chunk of CE_CHUNK tokens (or the policy's `ce_chunk`) at a time,
    each chunk checkpointed, so the (T, V) logits never exist."""
    B, S, D = x.shape
    xn = apply_norm(params["final_norm"], x, cfg.norm,
                    unit_offset=cfg.name.startswith("gemma"))
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(cfg.cdtype)
    T = B * S
    xt = xn.reshape(T, D).to(cfg.cdtype)
    tt = targets.reshape(T).long()
    mt = mask.reshape(T).float()
    pol = act_sharding.current()
    C = min(pol.ce_chunk if pol is not None and pol.ce_chunk else CE_CHUNK,
            T)
    pad = (-T) % C
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        tt = F.pad(tt, (0, pad))
        mt = F.pad(mt, (0, pad))
    carry = (torch.zeros((), dtype=torch.float32, device=x.device),) * 2
    for a in range(0, T + pad, C):
        args = (carry, xt[a:a + C], tt[a:a + C], mt[a:a + C], w,
                cfg.final_logit_softcap)
        carry = (checkpoint(_ce_chunk, *args, use_reentrant=False,
                            preserve_rng_state=False)
                 if torch.is_grad_enabled() else _ce_chunk(*args))
    tot, cnt = carry
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg, *, remat=True):
    """batch: {"tokens": (B,S), "loss_mask": (B,S) optional, "memory": opt,
    "frames": for enc-dec archs}. Next-token CE in fp32, chunked so full
    logits are never materialized, plus the MoE aux losses. Returns
    (loss + aux, {"ce", "aux"})."""
    tokens = batch["tokens"]
    memory = batch.get("memory")
    if cfg.encoder is not None:
        memory = encode(params, batch["frames"], cfg)
    x, _, aux = forward(params, tokens, cfg, memory=memory, remat=remat,
                        head="none")
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(tokens) if mask is None else mask)[:, 1:]
    loss = _ce_chunked(params, x[:, :-1], tokens[:, 1:], mask, cfg)
    return loss + aux, {"ce": loss, "aux": aux}


# ------------------------------------------------------------------ caches
def _layer_cache(cfg, spec, B, max_len, dtype, device):
    K, hd = cfg.n_kv_heads, cfg.hd
    L = cfg.n_superblocks

    def zeros(*shape, dt=dtype):
        return torch.zeros((L, *shape), dtype=dt, device=device)

    def write_head():                 # host-side: read without a sync
        return torch.zeros(L, dtype=torch.int32)
    if spec.mixer == "mamba":
        s = cfg.ssm
        return {"conv": zeros(B, s.d_conv - 1, cfg.d_inner),
                "ssm": zeros(B, cfg.d_inner, s.d_state, dt=torch.float32)}
    if spec.mixer == "cross_attn":
        M = cfg.memory_len()
        return {"ck": zeros(B, M, K, hd), "cv": zeros(B, M, K, hd)}
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": zeros(B, max_len, m.kv_lora_rank),
                "krope": zeros(B, max_len, m.qk_rope_head_dim),
                "pos": write_head()}
    # sliding-window layers only ever read the trailing `window` positions but
    # we keep the full ring for simplicity of positions bookkeeping.
    return {"k": zeros(B, max_len, K, hd), "v": zeros(B, max_len, K, hd),
            "pos": write_head()}


def init_cache(cfg, B, max_len, dtype=None, *, device):
    """Decode cache tree stacked on a leading superblock axis."""
    dtype = dtype or cfg.cdtype
    return {f"layer{i}": _layer_cache(cfg, spec, B, max_len, dtype, device)
            for i, spec in enumerate(cfg.block_pattern)}


def prefill(params, tokens, cfg, max_len, *, memory=None):
    """Run the full prompt, filling a decode-ready cache of size max_len.
    Returns (logits_last (B,V), cache)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                               memory=memory, remat=False, head="last")
    return logits[:, -1], cache


def decode_step(params, token, cache, cfg, pos, *, memory=None):
    """token: (B, 1) int; pos: int (current write index). Returns (logits
    (B, V), cache)."""
    positions = torch.tensor([pos], dtype=torch.int32, device=token.device)
    logits, cache, _ = forward(params, token, cfg, positions=positions,
                               cache=cache, memory=memory, remat=False)
    return logits[:, 0], cache

