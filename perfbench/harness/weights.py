"""The cell's weights, drawn by the benchmark from the run's seed on the
device, one large call a leaf (an expert leaf: one an expert), so that the
program and the reference start from the same tensors and the reference
can draw any leaf again by itself.

A leaf is named by its path in the program's parameter tree and drawn by
its last name:

  * a norm's `scale`, `mamba_D`: ones;
  * `mamba_A_log`: log(1 .. N) in each channel (S4D-real);
  * `mamba_dtproj_bias`: softplus^-1 of a dt log-uniform in [1e-3, 1e-1];
  * `mamba_conv_w`: normal, std 0.1;
  * every other leaf (matrices, biases, the embedding, the head, the
    router): normal, std 0.02.

Each leaf's generator is seeded from (seed, path) and, for an expert leaf
(its experts on the second axis of a stacked leaf), from (seed, path,
expert), so a rank that holds some of the experts draws exactly their
slice of the whole leaf.
"""
from __future__ import annotations

import hashlib
import math

import torch

EXPERT_LEAVES = ("moe_wg", "moe_wu", "moe_wd")


def leaf_seed(seed: int, path: str, expert=None) -> int:
    key = f"{int(seed)}:{path}" + ("" if expert is None else f":{expert}")
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8],
                          "little") & ((1 << 63) - 1)


def _fill(t, name, gen):
    if name in ("scale", "mamba_D"):
        return t.fill_(1.0)
    if name == "mamba_A_log":
        N = t.shape[-1]
        return t.copy_(torch.log(torch.arange(1, N + 1, dtype=t.dtype,
                                              device=t.device)).expand_as(t))
    if name == "mamba_dtproj_bias":
        u = torch.empty_like(t).uniform_(generator=gen)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))
    return t.normal_(0.0, 0.1 if name == "mamba_conv_w" else 0.02,
                     generator=gen)


def draw(path, shape, seed, device, experts=None):
    """The float32 leaf `path` of `shape`. `experts`: for an expert leaf
    (L, E_here, ...), the experts held, (first, count), drawn expert by
    expert; None draws every expert of it."""
    name = path.rsplit("/", 1)[-1]
    out = torch.empty(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    if name in EXPERT_LEAVES:
        first = 0 if experts is None else experts[0]
        part = torch.empty((shape[0], *shape[2:]), dtype=torch.float32,
                           device=device)
        for j in range(shape[1]):
            gen.manual_seed(leaf_seed(seed, path, first + j))
            out[:, j].copy_(_fill(part, name, gen))
        return out
    gen.manual_seed(leaf_seed(seed, path))
    return _fill(out, name, gen)
