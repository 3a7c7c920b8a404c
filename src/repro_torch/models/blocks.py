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
nothing).

The stacked parameters are cut into superblocks with `unbind`, so that
their gradient is assembled once, by one stack of the superblocks'
gradients, where a slice a superblock would each add a whole stacked
tensor of zeros.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_norm, init_norm, scaled
from repro_torch.tree import tree_map


def _residual_scale(cfg):
    if cfg.scale_depth:
        return cfg.scale_depth / (cfg.n_layers ** 0.5)
    return 1.0


# ------------------------------------------------------------------ one layer
def init_layer(gen, cfg, spec, *, lead=(), device):
    kw = dict(lead=lead, device=device)

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
        p["mixer"] = mamba_mod.init_mamba(gen, cfg, **kw)
    elif cfg.mla is not None and spec.mixer != "cross_attn":
        p["mixer"] = attn_mod.init_mla(gen, cfg, **kw)
    else:
        p["mixer"] = attn_mod.init_attention(gen, cfg, spec, **kw)
    if spec.ffn == "mlp":
        p["ffn"] = moe_mod.init_mlp(gen, cfg, **kw)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, cfg, **kw)
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
def init_superblock(gen, cfg, *, lead=(), device):
    return {f"layer{i}": init_layer(gen, cfg, spec, lead=lead, device=device)
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
def init_stack(gen, cfg, *, device):
    """Every leaf stacked on a leading (n_superblocks,) axis."""
    return init_superblock(gen, cfg, lead=(cfg.n_superblocks,), device=device)


def superblock(tree, i: int):
    """Superblock i's slice of a stacked tree: views, no copies."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree, n: int):
    """The n superblocks of a stacked tree, each a tree of views."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def apply_stack(params, x, cfg, *, positions, cache=None, memory=None,
                remat: bool = True):
    """Superblock after superblock of the stacked `params`, each under a
    checkpoint if `remat` and gradients are on; the stacked `cache`, if
    given, is updated in place. Returns (x, aux_sum)."""
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, sb in enumerate(unstack(params, cfg.n_superblocks)):
        kw = dict(positions=positions, memory=memory,
                  cache=None if cache is None else superblock(cache, i))
        if remat:
            x, a = checkpoint(apply_superblock, sb, x, cfg, **kw,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = apply_superblock(sb, x, cfg, **kw)
        aux = aux + a
    return x, aux
