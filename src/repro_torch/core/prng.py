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
initialiser: sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1)), with
XLA's CPU lowering of erf_inv (Giles' single-precision polynomial in
w = -log1p(-x*x)) and of log1p (a Cephes rational for |x| < sqrt(2) - 1,
else Cephes' logf of 1 + x), each multiply-add rounded once where the
CPU backend fuses it into an FMA.
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


def _fma(a, b, c) -> np.ndarray:
    """fp32 a * b + c rounded once (the fp32 product is exact in fp64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


_F32 = np.float32
# Cephes logf: the polynomial in x = m - 1 (its Horner split in three
# interleaved chains, as XLA emits it), and ln 2 as q2 + q1
_LOG_P = np.array([7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                   -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                   2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1],
                  np.float32)
_LN2_LO, _LN2_HI = _F32(-2.12194440e-4), _F32(0.693359375)
_SQRT_HALF = _F32(0.707106781186547524)
# Cephes log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x)
_LOG1P_P = np.array([4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                     6.5787325942061044846969e0, 2.9911919328553073277375e1,
                     6.0949667980987787057556e1, 5.7112963590585538103336e1,
                     2.0039553499201281259648e1], np.float32)
_LOG1P_Q = np.array([1.5062909083469192043167e1, 8.3047565967967209469434e1,
                     2.2176239823732856465394e2, 3.0909872225312059774938e2,
                     2.1642788614495947685003e2, 6.0118660497603843919306e1],
                    np.float32)
# Giles' erf_inv, for w < 5 (in w - 2.5) and w >= 5 (in sqrt(w) - 3)
_ERFINV_LO = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                       -4.39150654e-06, 0.00021858087, -0.00125372503,
                       -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_HI = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                       -0.00367342844, 0.00573950773, -0.0076224613,
                       0.00943887047, 1.00167406, 2.83297682], np.float32)


def _logf(y: np.ndarray) -> np.ndarray:
    """XLA's CPU fp32 log of y >= 0 (Cephes logf, FMAs where fused)."""
    bits = np.maximum(y, _F32(2.0 ** -126)).view(np.uint32)
    e = (((bits >> np.uint32(23)).astype(np.int32) - 127).astype(_F32)
         + _F32(1))
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(_F32)
    low = m < _SQRT_HALF
    e = e - low.astype(_F32)
    x = (m - _F32(1)) + np.where(low, m, _F32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    a = _fma(_fma(x, p[0], p[1]), x, p[2])
    b = _fma(_fma(x, p[3], p[4]), x, p[5])
    c = _fma(_fma(x, p[6], p[7]), x, p[8])
    a = _fma(_fma(_fma(a, x3, b), x3, c), x3, e * _LN2_LO)
    out = _fma(e, _LN2_HI, _fma(x2, _F32(-0.5), x) + a)
    out = np.where(y < 0, _F32(np.nan), out)
    out = np.where(y == 0, _F32(-np.inf), out)
    return np.where(y == np.inf, _F32(np.inf), out).astype(_F32)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU fp32 log1p."""
    x2 = x * x
    num = np.full_like(x, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        num = _fma(num, x, c)
    den = np.ones_like(x)
    for c in _LOG1P_Q:
        den = _fma(den, x, c)
    small = x + _fma(x2, _F32(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    _logf(x + _F32(1))).astype(_F32)


def erfinv32(x) -> np.ndarray:
    """`jax.lax.erf_inv` of fp32 x in [-1, 1], as XLA's CPU backend
    computes it."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):   # at |x| = 1
        return _erfinv32(x)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -_log1p(-(x * x))
    lo = w < _F32(5)
    t = np.where(lo, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lo, _ERFINV_LO[0], _ERFINV_HI[0])
    for a, b in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, t, np.where(lo, a, b))
    return np.where(np.abs(x) == 1, x * _F32(np.inf), p * x).astype(_F32)


def normal(key, shape=()) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)` for a uint32[2] key."""
    lo = np.nextafter(_F32(-1), _F32(0))
    return (_F32(np.sqrt(2)) * erfinv32(uniform(key, shape, lo, 1.0))
            ).astype(_F32)


def choice(key, n: int, p) -> int:
    """`jax.random.choice(key, n, p=p)` (one draw, with replacement):
    searchsorted(cumsum(p), cumsum(p)[-1] * (1 - uniform(key)))."""
    p_cuml = cumsum(np.asarray(p, np.float32))
    if len(p_cuml) != n:
        raise ValueError(f"p has {len(p_cuml)} entries, n is {n}")
    r = p_cuml[-1] * (np.float32(1.0) - uniform(key, ()))
    return int(np.searchsorted(p_cuml, r, side="left"))
