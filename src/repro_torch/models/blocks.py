"""Layer / superblock composition.

A *superblock* is one repetition of ``cfg.block_pattern``. As in the
reference (`repro.models.blocks`), the stack's parameters (and a decode
cache) are stacked on a leading superblock axis; the forward loops over
that axis in Python where the reference scans it.

Remat: with `remat=True` (the reference's default) and gradients on, each
superblock runs under `torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`, the reference's `jax.checkpoint` with
`nothing_saveable`: the forward keeps only each superblock's input, and
the backward runs the superblock's forward again before its own. Serving
passes `remat=False` (and runs without gradients, where it changes
nothing). As in the reference, the active sharding policy's `remat`
picks the mode when `remat=True`: "full" (the above), "none" (no
checkpoint) or "dots", the counterpart of
`dots_with_no_batch_dims_saveable`: a selective checkpoint
(`create_selective_checkpoint_contexts`) that keeps the outputs of the
2-D matmuls (`aten.mm`, `aten.addmm`) and recomputes everything else,
batched products (`bmm`) and the kernels' autograd Functions included,
as the reference recomputes its einsum attention.

The stacked parameters are cut into superblocks with `unbind`, so that
their gradient is assembled once, by one stack of the superblocks'
gradients, where a slice a superblock would each add a whole stacked
tensor of zeros.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import prng
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_norm, init_norm, scaled,
                                       split_keys)
from repro_torch.sharding import act as act_sharding
from repro_torch.tree import tree_map

# the ops whose outputs "dots" keeps: matmuls without a batch dim
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _residual_scale(cfg):
    if cfg.scale_depth:
        return cfg.scale_depth / (cfg.n_layers ** 0.5)
    return 1.0


# ------------------------------------------------------------------ one layer
def init_layer(key, cfg, spec, *, device):
    ks = split_keys(key, 4)
    lead = ks[0].shape[:-1]
    kw = dict(device=device)

    def norm():
        return init_norm((*lead, cfg.d_model), cfg.norm, cfg.pdtype,
                         device=device)
    p = {"norm1": norm()}
    if spec.ffn != "none":
        p["norm2"] = norm()
    if cfg.name.startswith("gemma"):   # sandwich norms (pre+post)
        p["postnorm1"] = norm()
        p["postnorm2"] = norm()
    if spec.mixer == "mamba":
        p["mixer"] = mamba_mod.init_mamba(ks[0], cfg, **kw)
    elif cfg.mla is not None and spec.mixer != "cross_attn":
        p["mixer"] = attn_mod.init_mla(ks[0], cfg, **kw)
    else:
        p["mixer"] = attn_mod.init_attention(ks[0], cfg, spec, **kw)
    if spec.ffn == "mlp":
        p["ffn"] = moe_mod.init_mlp(ks[1], cfg, **kw)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(ks[1], cfg, **kw)
    return p


def apply_layer(p, x, cfg, spec, *, positions, cache=None, memory=None):
    """Returns (x, aux); a cache is updated in place."""
    rs = _residual_scale(cfg)
    unit = cfg.name.startswith("gemma")
    h = apply_norm(p["norm1"], x, cfg.norm, unit_offset=unit)

    if spec.mixer == "mamba":
        mix = mamba_mod.apply_mamba(p["mixer"], h, cfg, cache=cache)
    elif cfg.mla is not None and spec.mixer != "cross_attn":
        mix = attn_mod.apply_mla(p["mixer"], h, cfg, positions=positions,
                                 cache=cache)
    else:
        # attn_nope: RoPE suppression handled inside apply_attention via spec
        mix = attn_mod.apply_attention(
            p["mixer"], h, cfg, spec, positions=positions, cache=cache,
            memory=memory)
    if "postnorm1" in p:
        mix = apply_norm(p["postnorm1"], mix, cfg.norm, unit_offset=unit)
    x = x + scaled(mix, rs)

    aux = {}
    if spec.ffn != "none":
        h2 = apply_norm(p["norm2"], x, cfg.norm, unit_offset=unit)
        if spec.ffn == "moe":
            f, aux = moe_mod.apply_moe(p["ffn"], h2, cfg)
        else:
            f = moe_mod.apply_mlp(p["ffn"], h2, cfg)
        if "postnorm2" in p:
            f = apply_norm(p["postnorm2"], f, cfg.norm, unit_offset=unit)
        x = x + scaled(f, rs)
    return x, aux


# ------------------------------------------------------------------ superblock
def init_superblock(key, cfg, *, device):
    ks = split_keys(key, len(cfg.block_pattern))
    return {f"layer{i}": init_layer(ks[i], cfg, spec, device=device)
            for i, spec in enumerate(cfg.block_pattern)}


def apply_superblock(p, x, cfg, *, positions, cache=None, memory=None):
    """cache: None or dict {"layer{i}": entry}. Returns (x, aux_sum)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.block_pattern):
        entry = cache[f"layer{i}"] if cache is not None else None
        x, aux = apply_layer(p[f"layer{i}"], x, cfg, spec,
                             positions=positions, cache=entry, memory=memory)
        for v in aux.values():
            aux_total = aux_total + v
    return x, aux_total


# ------------------------------------------------------------------ the stack
def init_stack(key, cfg, *, device):
    """Every leaf stacked on a leading (n_superblocks,) axis: superblock i
    from the i-th of `key` split n_superblocks ways, as the reference's
    vmapped init."""
    return init_superblock(prng.split(key, cfg.n_superblocks), cfg,
                           device=device)


def superblock(tree, i: int):
    """Superblock i's slice of a stacked tree: views, no copies."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree, n: int):
    """The n superblocks of a stacked tree, each a tree of views."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the 2-D matmuls' outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_mode(remat: bool) -> str:
    """The reference's mode: the policy's `remat` ("full", "dots" or
    "none") when one is set, else "full"; "none" without `remat` or
    without gradients."""
    pol = act_sharding.current()
    mode = pol.remat if pol is not None else "full"
    return mode if remat and torch.is_grad_enabled() else "none"


def apply_stack(params, x, cfg, *, positions, cache=None, memory=None,
                remat: bool = True):
    """Superblock after superblock of the stacked `params`, each under a
    checkpoint of the mode `remat_mode` gives; the stacked `cache`, if
    given, is updated in place. Returns (x, aux_sum)."""
    mode = remat_mode(remat)
    ckpt = dict(use_reentrant=False, preserve_rng_state=False)
    if mode == "dots":
        ckpt["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, sb in enumerate(unstack(params, cfg.n_superblocks)):
        kw = dict(positions=positions, memory=memory,
                  cache=None if cache is None else superblock(cache, i))
        if mode == "none":
            x, a = apply_superblock(sb, x, cfg, **kw)
        else:
            # the recompute under this policy (the MoE dispatch, the
            # attention knobs), in whichever thread the backward runs it
            x, a = checkpoint(act_sharding.bound(apply_superblock), sb, x,
                              cfg, **kw, **ckpt)
        aux = aux + a
    return x, aux
