"""Threefry-2x32 PRNG keys on the host, bit-equal to the reference's.

The reference keys every serving lane with `jax.random.PRNGKey(seed)` and
advances it once per decision with `jax.random.split(key, 2)` inside its
batched act (`repro/core/agent.py`). Keys are uint32[2]; with 64-bit mode
off, `PRNGKey(s)` is `[0, s mod 2**32]`, and the default (partitionable)
split of key k into `num` keys is `threefry2x32(k, hi=0, lo=i)` for
i < num. This module reproduces both in numpy so the port's lanes carry
the same key bytes as the reference's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

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
