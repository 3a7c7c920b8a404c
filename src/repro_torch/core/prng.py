"""Threefry-2x32 PRNG keys and sampling, bit-equal to the reference's.

The reference keys every serving lane with `jax.random.PRNGKey(seed)` and
advances it once per decision with `jax.random.split(key, 2)` inside its
batched act (`repro/core/agent.py`). Keys are uint32[2]; with 64-bit mode
off, `PRNGKey(s)` is `[0, s mod 2**32]`, and the default (partitionable)
split of key k into `num` keys is `threefry2x32(k, hi=0, lo=i)` for
i < num. This module reproduces both in numpy so the port's lanes carry
the same key bytes as the reference's.

The sampling half follows jax 0.9.0 with the same config:
`random_bits` (32-bit: the two threefry output words of counter
(hi, lo) = the flat index, xored), `uniform` (the top 23 bits as the
mantissa of a float in [1, 2), minus 1, scaled, then max(minval, .)),
`categorical` (the Gumbel-max trick of `jax.random.categorical`, mode
"low") and `choice` with probabilities (`jax.random.choice`: an inverse
CDF over `jnp.cumsum`, whose order of fp32 sums `cumsum` reproduces).
Bits and uniforms are made on the host; `categorical` takes the Gumbel
transform, the add and the argmax on the logits' device.

`normal` is `jax.random.normal` (fp32), the reference's weight
initialiser, drawn on the CPU by the threefry kernel's plain version
(`kernels/ref.py`, which holds XLA's CPU lowerings of erf_inv, log1p and
log).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast uint32 arrays: key (k0, k1), counter (x0, x1)."""
    k0, k1, x0, x1 = np.broadcast_arrays(
        *(np.atleast_1d(np.asarray(v, np.uint32)) for v in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` (64-bit mode off) as uint32[2]."""
    return np.array([0, int(seed) % 2 ** 32], np.uint32)


def split(keys, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` for uint32[2] keys, vectorised over
    leading dimensions: (..., 2) -> (..., num, 2). For a batch of lane keys
    `split(keys)[:, 0]` is each lane's next chain head and `[:, 1]` the
    subkey its decision would sample with."""
    keys = np.asarray(keys, np.uint32)
    b0, b1 = threefry2x32(keys[..., :1], keys[..., 1:],
                          np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)` (uint32) for a uint32[2] key, or for
    a (..., 2) stack of keys -> (..., *shape): one draw per key."""
    keys = np.asarray(key, np.uint32)
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    counts = np.arange(size, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = counts.astype(np.uint32)
    b0, b1 = threefry2x32(keys[..., :1], keys[..., 1:], hi, lo)
    return (b0 ^ b1).reshape(keys.shape[:-1] + shape)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`, keys
    stacked as in `random_bits`."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts the scale and shift into one FMA (one rounding): the
    # fp32 product is exact in fp64
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel_uniforms(subkeys, d: int) -> np.ndarray:
    """The uniforms behind `jax.random.categorical` for (B, 2) subkeys
    over d categories: (B, d) float32 in [tiny, 1)."""
    return uniform(subkeys, (d,), minval=_TINY, maxval=1.0)


def categorical(subkeys, logits: torch.Tensor) -> torch.Tensor:
    """`jax.vmap(jax.random.categorical)(subkeys, logits)`: one draw per
    row of (B, d) fp32 logits with its (B, 2) uint32 subkey, as
    argmax(gumbel + logits), ties to the first index. Returns (B,) int64
    on the logits' device."""
    u = torch.from_numpy(gumbel_uniforms(subkeys, logits.shape[-1])).to(
        logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=-1)


def _sequential_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    acc = np.float32(0.0)
    for i, v in enumerate(x):
        acc = np.float32(acc + v)
        out[i] = acc
    return out


def cumsum(x, base: int = 16) -> np.ndarray:
    """`jnp.cumsum` of a 1-D float32 vector, in the order XLA's CPU
    backend sums it: runs of `base` summed left to right, each run's
    total carried by the same scan over the totals, added last."""
    x = np.asarray(x, np.float32)
    n = len(x)
    if n <= base:
        return _sequential_cumsum(x)
    rows = -(-n // base)
    padded = np.zeros(rows * base, np.float32)
    padded[:n] = x
    runs = np.stack([_sequential_cumsum(r)
                     for r in padded.reshape(rows, base)])
    carry = np.concatenate([[np.float32(0.0)],
                            cumsum(runs[:, -1], base)[:-1]]).astype(np.float32)
    return (runs + carry[:, None]).reshape(-1)[:n]


def normal(key, shape=()) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)` for a uint32[2] key: the
    threefry kernel's plain version (`kernels.ref.random_normal_ref`) on
    the CPU."""
    from repro_torch.kernels import threefry      # it imports this module
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    return threefry.normal(np.asarray(key, np.uint32), n,
                           device="cpu").numpy().reshape(shape)


def choice(key, n: int, p) -> int:
    """`jax.random.choice(key, n, p=p)` (one draw, with replacement):
    searchsorted(cumsum(p), cumsum(p)[-1] * (1 - uniform(key)))."""
    p_cuml = cumsum(np.asarray(p, np.float32))
    if len(p_cuml) != n:
        raise ValueError(f"p has {len(p_cuml)} entries, n is {n}")
    r = p_cuml[-1] * (np.float32(1.0) - uniform(key, ()))
    return int(np.searchsorted(p_cuml, r, side="left"))
