"""Shared model primitives: norms, RoPE, activations, initializers.

Functional, as the reference's `repro.models.common`: every module is an
``init_*(key, ...) -> params`` (a dict of tensors) plus an ``apply`` that
takes the params dict. Norm math runs in fp32 regardless of compute dtype.

Initializers take the reference's `jax.random` keys as uint32 numpy
arrays (`core.prng`): a key is (2,), or a (*lead, 2) stack of keys whose
leading axes (the superblock axis) every tensor of the initializer is
stacked on, as the reference's vmapped `init_stack` stacks them.
`split_keys` splits each key of a stack, and `normal_init` draws
``stddev * jax.random.normal(key, shape, float32)`` cast to `dtype`, bit
for bit the reference's, on the leaf's device: through the threefry
kernel on the card, its plain version on the CPU, nothing on ``meta``.
Under `drawn_as(names, dtype)` a leaf whose name is in `names` is drawn
in that dtype instead: the kernel rounds each fp32 draw to it, so the
leaf is the one a later cast would give, and the wider leaf never exists
(the server's serving copy, `lm.init_params(..., serving=True)`).
Under `drawn_rows(names, j, n)` a leaf whose name is in `names` is drawn
as its j-th of n equal slices along its first own dim (the experts of a
rank of a joined mesh): each key's elements from offset j * numel / n of
its flat draw, bit-equal to that slice of the whole leaf, which is never
drawn.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels import threefry


_DRAWN_AS = contextvars.ContextVar("drawn_as", default=None)
_DRAWN_ROWS = contextvars.ContextVar("drawn_rows", default=None)


@contextlib.contextmanager
def drawn_as(names, dtype):
    """Within it, `normal_init` draws a leaf named in `names` in `dtype`."""
    token = _DRAWN_AS.set((frozenset(names), dtype))
    try:
        yield
    finally:
        _DRAWN_AS.reset(token)


@contextlib.contextmanager
def drawn_rows(names, j: int, n: int):
    """Within it, `normal_init` draws only the j-th of n slices along the
    first dim of a leaf named in `names`."""
    token = _DRAWN_ROWS.set((frozenset(names), j, n))
    try:
        yield
    finally:
        _DRAWN_ROWS.reset(token)


def normal_init(key, shape, dtype, stddev=0.02, *, device, name=None):
    """(*lead, *shape) for a (*lead, 2) stack of keys; `name` is the
    leaf's (see `drawn_as` and `drawn_rows`)."""
    key = np.asarray(key, np.uint32)
    drawn = _DRAWN_AS.get()
    if drawn is not None and name in drawn[0]:
        dtype = drawn[1]
    shape, kw = tuple(shape), {}
    rows = _DRAWN_ROWS.get()
    if rows is not None and name in rows[0]:
        _, j, n = rows
        if shape[0] % n:
            raise ValueError(f"{name}: {shape[0]} rows in {n} slices")
        shape = (shape[0] // n, *shape[1:])
        kw["offset"] = j * math.prod(shape)
    out = threefry.normal(key, math.prod(shape), stddev=stddev, dtype=dtype,
                          device=device, **kw)
    return out.view(*key.shape[:-1], *shape)


def split_keys(key, n):
    """`jax.random.split(key, n)` as a list of n keys, each of a stack's
    own shape (*lead, 2)."""
    ks = prng.split(key, n)
    return [ks[..., i, :] for i in range(n)]


# ---------------------------------------------------------------- norms
def init_norm(shape, kind: str, dtype, *, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    elif kind == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(params, x, kind: str, eps: float = 1e-6,
               unit_offset: bool = False):
    """unit_offset: gemma-style (1 + scale) parameterization."""
    xf = x.float()
    scale = params["scale"].float()
    if unit_offset:
        scale = scale + 1.0
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * scale
    elif kind == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps) * scale \
            + params["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) rotated pairwise-half style; positions: (S,) or
    (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- activations
def _gelu(x):
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping; cap <= 0 disables."""
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def scaled(x, s: float):
    """x * s with s first rounded to x's dtype, as jax multiplies a tensor
    by a Python float; x itself for s = 1."""
    if s == 1.0:
        return x
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------- dense
def init_dense(key, d_in, d_out, dtype, bias=False, stddev=0.02, name="w",
               *, device):
    p = {name: normal_init(key, (d_in, d_out), dtype, stddev, device=device,
                           name=name)}
    if bias:
        p[name + "_bias"] = torch.zeros((*np.shape(key)[:-1], d_out),
                                        dtype=dtype, device=device)
    return p


def apply_dense(p, x, name="w", cdtype=None):
    """x @ p[name] (+ bias), both cast to `cdtype` first. A weight already
    in `cdtype` (the server's serving copy, `lm.serving_params`) is used
    as it is: `.to` returns it uncopied."""
    w = p[name]
    if cdtype is not None:
        w = w.to(cdtype)
        x = x.to(cdtype)
    y = x @ w
    if name + "_bias" in p:
        y = y + p[name + "_bias"].to(y.dtype)
    return y
