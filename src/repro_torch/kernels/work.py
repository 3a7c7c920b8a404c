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


def attention_work(BH, BKV, Sq, Sk, hd, *, causal, window, itemsize,
                   lse=False) -> Tuple[int, int]:
    """flash_attention on q (BH, Sq, hd), k/v (BKV, Sk, hd): bytes (q
    read, the output written, the needed keys of k and v read; with
    `lse`, each row's logsumexp written for the backward, fp32) and
    FLOPs (4·hd an allowed pair and head: QK^T and PV). Without `lse`
    it is the function's own work, the kernels' bound."""
    pairs = allowed_pairs(Sq, Sk, causal, window)
    keys = needed_keys(Sq, Sk, causal, window)
    n_bytes = ((2 * BH * Sq * hd + 2 * BKV * keys * hd) * itemsize
               + (4 * BH * Sq if lse else 0))
    return n_bytes, 4 * pairs * hd * BH


def attention_bwd_work(BH, BKV, Sq, Sk, hd, *, causal, window, itemsize,
                       lse=False) -> Tuple[int, int]:
    """flash_attention's backward: bytes (q, the output and its cotangent
    read, dq written; the needed keys of k and v read; dk and dv written
    whole; with `lse`, the forward's logsumexp read, fp32) and FLOPs (5
    products of 2·hd an allowed pair and head: QK^T and dO V^T
    recomputed, P^T dO, dS K and dS^T Q). Without `lse` it is the
    function's own work, the kernels' bound."""
    pairs = allowed_pairs(Sq, Sk, causal, window)
    keys = needed_keys(Sq, Sk, causal, window)
    n_bytes = ((4 * BH * Sq * hd + 2 * BKV * keys * hd
                + 2 * BKV * Sk * hd) * itemsize
               + (4 * BH * Sq if lse else 0))
    return n_bytes, 10 * pairs * hd * BH


def scan_states(B, S, di, N, chunk) -> int:
    """Elements of the states the scan forward keeps for its backward,
    one before every `chunk`-th step (0: none kept)."""
    return B * -(-S // chunk) * di * N if chunk else 0


def scan_work(B, S, di, N, *, skip=True, h0=False, states=0
              ) -> Tuple[int, int]:
    """mamba_scan on x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N): bytes
    (x, dt, y, A, Bs, Cs, D, h0 and h_last, fp32; with `states` a chunk,
    the states kept for the backward every `states` steps written) and
    FLOPs: per (b, t, d, n) dt*A, exp, a*h + b (2), dx*B, y += C*h (2);
    per (b, t, d) dt*x and the skip term's FMA (2). Without `states` it
    is the function's own work, the kernel's bound."""
    n_bytes = 4 * (3 * B * S * di + di * N + 2 * B * S * N
                   + (di if skip else 0) + (2 if h0 else 1) * B * di * N
                   + scan_states(B, S, di, N, states))
    return n_bytes, 7 * B * S * di * N + 3 * B * S * di


def scan_bwd_work(B, S, di, N, *, skip=True, h0=False, gy=True, gh=False,
                  states=0) -> Tuple[int, int]:
    """mamba_scan's backward: bytes (x, dt, A, Bs, Cs, D and h0 read with
    the cotangents gy and gh; dx, ddt, dA, dB, dC, dD and dh0 written,
    fp32; with `states` a chunk, the forward's states every `states`
    steps read) and FLOPs: per (b, t, d, n) the recomputed step (dt*A,
    exp, a*h + b, dx*B: 5), dh += gy*C, dC += gy*h, dB += dh*dx,
    u += dh*B, w += g*A, dA += g*dt (2 each), g = dh*h*a (2), dh *= a:
    20; per (b, t, d) dt*x, dx = u*dt, ddt = u*x + w, the skip term's
    dx += gy*D and dD += gy*x: 9. Without `states` it is the function's
    own work, the kernels' bound."""
    big = B * S * di
    n_bytes = 4 * ((4 + (1 if gy else 0)) * big + 2 * di * N
                   + 4 * B * S * N + (2 * di if skip else 0)
                   + ((2 if h0 else 0) + (1 if gh else 0)) * B * di * N
                   + scan_states(B, S, di, N, states))
    return n_bytes, 20 * big * N + 9 * big


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


# A draw of the threefry kernel, counted from its plain version
# (`ref.random_normal_ref`, `ref.random_gumbel_ref`): (operations, of
# them FMAs) of each part, one operation each for an integer or fp32 add,
# multiply, FMA, divide, square root, negation, abs, compare, select,
# shift, bitwise op, rotation, conversion and store. What depends on the
# key alone (its third word, a word plus a round's constant) is not
# counted. These are what the function needs; chip_smoke.py counts
# beside them the instructions the compiled kernel issues.
THREEFRY_PARTS = {
    # the counter's add, the key's first injection (2), 20 rounds of add,
    # rotation and xor, 5 injections of 2 adds, the output words' xor
    "threefry": (74, 0),
    # shift, or, minus 1, the FMA by (hi - lo) and lo, max
    "uniform": (5, 1),
    # Cephes logf: the exponent and mantissa split (17), its polynomial
    # and ln 2 (11 FMAs), the three special cases (6)
    "log": (34, 11),
    # log1p's rational (12 FMAs), x^3 P/Q (3), the FMA by -1/2, the add,
    # the |x| test and select, and 1 + x for its log (a "log" of its own)
    "log1p": (22, 13),
    # erf_inv around log1p: -(x * x), -w, w < 5, both t (4) and the
    # select, Giles' 9 coefficients (9 selects, 8 FMAs), the |x| = 1 case
    "erf_inv": (30, 8),
    # normal: sqrt(2) * ., stddev * ., store; Gumbel: two negations, store
    "tail": (3, 0),
}
THREEFRY_DRAW = {
    kind: tuple(sum(THREEFRY_PARTS[p][i] for p in parts) for i in (0, 1))
    for kind, parts in (
        ("normal", ("threefry", "uniform", "log", "log1p", "erf_inv",
                    "tail")),
        ("gumbel", ("threefry", "uniform", "log", "log", "tail")))}


def threefry_work(n, itemsize, *, gumbel=False) -> Tuple[int, int]:
    """The threefry kernel's n draws: bytes (each output written once; the
    keys are a few bytes) and operations (THREEFRY_DRAW's, an FMA as 2)."""
    ops, fmas = THREEFRY_DRAW["gumbel" if gumbel else "normal"]
    return n * itemsize, n * (ops + fmas)
