"""The work each kernel does, from its shapes: the bytes it must move
(each input read once, each output written once) and the operations it
runs, and the least time an NVIDIA H100 SXM could take for them.

These are the formulas `chip_smoke.py` holds every kernel's time against,
and the records a kernel wrapper gives an active op counter
(`launch.opanalysis`), so that a count on any device counts the program
the card runs. Where the work depends on the data (the tree kernels'
real nodes), the caller passes what its data needs; a counter, which
reads no data, passes every node.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at
the full power limit of 700 W.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 tensor cores, dense


def bound(n_bytes, flops, peak) -> Dict[str, object]:
    """The least time for `n_bytes` over the memory rate and `flops` over
    `peak`: the larger of the two, and which one it is."""
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / peak * 1e3
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations"}


def allowed_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the masks allow in one head, queries
    right-aligned against the keys."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def needed_keys(Sq, Sk, causal, window) -> int:
    """Keys of one k/v head that some query row may attend to: the bytes
    of k and v the call must read."""
    off = Sk - Sq
    hi = min(Sk - 1, Sq - 1 + off) if causal else Sk - 1
    lo = max(0, off - window + 1) if window > 0 else 0
    return max(0, hi - lo + 1)


def attention_work(BH, BKV, Sq, Sk, hd, *, causal, window, itemsize
                   ) -> Tuple[int, int]:
    """flash_attention on q (BH, Sq, hd), k/v (BKV, Sk, hd): bytes (q
    read, the output written, the needed keys of k and v read) and
    FLOPs (4·hd an allowed pair and head: QK^T and PV)."""
    pairs = allowed_pairs(Sq, Sk, causal, window)
    keys = needed_keys(Sq, Sk, causal, window)
    n_bytes = (2 * BH * Sq * hd + 2 * BKV * keys * hd) * itemsize
    return n_bytes, 4 * pairs * hd * BH


def scan_work(B, S, di, N, *, skip=True, h0=False) -> Tuple[int, int]:
    """mamba_scan on x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N): bytes
    (x, dt, y, A, Bs, Cs, D, h0 and h_last, fp32) and FLOPs: per (b, t,
    d, n) dt*A, exp, a*h + b (2), dx*B, y += C*h (2); per (b, t, d) dt*x
    and the skip term's FMA (2)."""
    n_bytes = 4 * (3 * B * S * di + di * N + 2 * B * S * N
                   + (di if skip else 0) + (2 if h0 else 1) * B * di * N)
    return n_bytes, 7 * B * S * di * N + 3 * B * S * di


def tree_conv_work(B, N, F, H, nodes) -> Tuple[int, int]:
    """tree_conv on feat (B, N, F), weights (F, H) x3 and b (H,): bytes
    (inputs, the int32 children, the mask and the output, fp32) and the
    FMAs of `nodes` real nodes (2 FLOPs each, three products)."""
    n_bytes = 4 * (B * N * F + 3 * B * N + 3 * F * H + H + B * N * H)
    return n_bytes, 2 * 3 * nodes * F * H


def tree_cnn_fused_work(B, N, F, H, nodes) -> Tuple[int, int]:
    """tree_cnn_fused: bytes (the tree batch, the three layers' weights,
    the (B, H) output) and the three layers' FMAs at `nodes` real
    nodes."""
    weights = 3 * F * H + H + 2 * (3 * H * H + H)
    n_bytes = 4 * (B * N * F + 3 * B * N + B * H + weights)
    return n_bytes, 2 * 3 * nodes * (F + 2 * H) * H


def tree_cnn_fused_bwd_work(B, N, F, H, nodes) -> Tuple[int, int]:
    """tree_cnn_fused's backward (weight gradients): bytes (the tree
    batch, the (B, H) cotangent, the weights read and their gradients
    written) and the FMAs the real nodes need: the three layers'
    recompute, their weight gradients and the input gradients of layers
    3 and 2."""
    weights = 3 * F * H + H + 2 * (3 * H * H + H)
    n_bytes = 4 * (B * N * F + 3 * B * N + B * H + 2 * weights)
    return n_bytes, 2 * nodes * H * (6 * F + 18 * H)
