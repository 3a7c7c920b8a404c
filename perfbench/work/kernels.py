"""The work of the program's hand-written kernels, from their shapes: the
bytes the function must move (each input read once, each output written
once) and the operations it runs, and the least time an NVIDIA H100 SXM
could take for them. What a kernel saves for its backward or reads again
is never counted: each bound is the function's own work.

A frozen copy of the program's `kernels/work.py` formulas, kept here so
that a change to the program cannot move the yardstick; the benchmark's
tests hold the two equal at the cells' shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full power limit of 700 W.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 tensor cores, dense


def bound_s(n_bytes, flops, peak) -> float:
    """The least seconds for `n_bytes` at the memory rate and `flops` at
    `peak`: the larger of the two."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def allowed_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the masks allow in one head, queries
    right-aligned against the keys."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def needed_keys(Sq, Sk, causal, window) -> int:
    """Keys of one k/v head that some query row may attend to."""
    off = Sk - Sq
    hi = min(Sk - 1, Sq - 1 + off) if causal else Sk - 1
    lo = max(0, off - window + 1) if window > 0 else 0
    return max(0, hi - lo + 1)


def attention_work(BH, BKV, Sq, Sk, hd, *, causal, window, itemsize
                   ) -> Tuple[int, int]:
    """flash_attention on q (BH, Sq, hd), k/v (BKV, Sk, hd): bytes (q
    read, the output written, the needed keys of k and v read) and FLOPs
    (4·hd an allowed pair and head: QK^T and PV)."""
    pairs = allowed_pairs(Sq, Sk, causal, window)
    keys = needed_keys(Sq, Sk, causal, window)
    n_bytes = (2 * BH * Sq * hd + 2 * BKV * keys * hd) * itemsize
    return n_bytes, 4 * pairs * hd * BH


def attention_bwd_work(BH, BKV, Sq, Sk, hd, *, causal, window, itemsize
                       ) -> Tuple[int, int]:
    """flash_attention's backward: bytes (q, the output and its cotangent
    read, dq written; the needed keys of k and v read; dk and dv written
    whole) and FLOPs (5 products of 2·hd an allowed pair and head)."""
    pairs = allowed_pairs(Sq, Sk, causal, window)
    keys = needed_keys(Sq, Sk, causal, window)
    n_bytes = (4 * BH * Sq * hd + 2 * BKV * keys * hd
               + 2 * BKV * Sk * hd) * itemsize
    return n_bytes, 10 * pairs * hd * BH


def scan_work(B, S, di, N, *, skip=True, h0=False) -> Tuple[int, int]:
    """mamba_scan on x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N): bytes
    (x, dt, y, A, Bs, Cs, D, h0 and h_last, fp32) and FLOPs (per (b, t,
    d, n) 7, per (b, t, d) 3)."""
    n_bytes = 4 * (3 * B * S * di + di * N + 2 * B * S * N
                   + (di if skip else 0) + (2 if h0 else 1) * B * di * N)
    return n_bytes, 7 * B * S * di * N + 3 * B * S * di


def scan_bwd_work(B, S, di, N, *, skip=True, h0=False, gy=True, gh=False
                  ) -> Tuple[int, int]:
    """mamba_scan's backward: bytes (x, dt, A, Bs, Cs, D and h0 read with
    the cotangents gy and gh; dx, ddt, dA, dB, dC, dD and dh0 written,
    fp32) and FLOPs (per (b, t, d, n) 20, per (b, t, d) 9)."""
    big = B * S * di
    n_bytes = 4 * ((4 + (1 if gy else 0)) * big + 2 * di * N
                   + 4 * B * S * N + (2 * di if skip else 0)
                   + ((2 if h0 else 0) + (1 if gh else 0)) * B * di * N)
    return n_bytes, 20 * big * N + 9 * big
