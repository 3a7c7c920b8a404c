"""Plain PyTorch versions of the kernels: what each kernel wrapper runs for
CPU tensors, and what the kernels are held to on the card. They run on
any device.

`flash_attention_ref`, `mamba_scan_ref` and `tree_conv_ref` keep the
reference oracles' signatures and semantics (the allclose ground truth);
`flash_attention_ref` also takes GQA k/v, as the kernel does.
`flash_attention_bwd_ref` and `mamba_scan_bwd_ref` are the plain versions
of the two backward kernels: the cotangents of those oracles' inputs (the
reference differentiates its oracles with autodiff; the tests hold these
to `jax.vjp` of them).
`flash_attention_split_ref` is the attention decode kernel's algorithm
(key splits, then a log-sum-exp merge), and `mamba_scan_lanes_ref` the
scan kernel's order of sums (states split over lanes, then a butterfly
over the lanes), for the tests to hold to the reference; no wrapper runs
them.
`tree_conv_batch_ref` and `tree_cnn_fused_ref` are the plain versions of
the two tree kernels, and `tree_cnn_fused_bwd_ref` that of the fused
encoder's backward kernel: autograd through `tree_cnn_fused_ref`, as the
reference's `_fused_bwd` pulls the cotangent through its jnp forward. They read a zero row for a child index outside
[0, N), as the reference's Pallas kernels' one-hots do, where the oracle
`tree_conv_ref` gathers with `h[idx]` (past the end clamps to the last
row, a negative index counts from the end).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng


def _mask(Sq, Sk, causal, window, device):
    """(Sq, Sk) allowed pairs, queries right-aligned against the keys."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, return_lse=False):
    """q: (BH, Sq, hd), k/v: (BKV, Sk, hd) with BH % BKV == 0; query row b
    reads k/v row b // (BH / BKV). fp32 softmax, full scores. Queries are
    right-aligned: qpos = i + Sk - Sq. Fully-masked rows -> 0. Returns
    (BH, Sq, hd) in q's dtype; with `return_lse`, also each row's
    logsumexp of its masked scores (BH, Sq) fp32, +inf on a row with no
    allowed key (what the forward kernels save for the backward: exp(s -
    lse) is then 0 on every key)."""
    G = q.shape[0] // k.shape[0]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=0), v.repeat_interleave(G, dim=0)
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)   # fully-masked -> 0
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    return out, torch.where(torch.isinf(lse), torch.inf, lse)


def _scores(q, k, *, causal, window, softcap, scale):
    """Masked fp32 scores (BH, Sq, Sk) of GQA q and k, -inf where masked."""
    G = q.shape[0] // k.shape[0]
    if G > 1:
        k = k.repeat_interleave(G, dim=0)
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    return s.masked_fill(~mask, -torch.inf)


def split_key_ranges(Sq, Sk, *, causal, window, splits, tile):
    """The key ranges [a, b) of the attention decode kernel's splits: the
    tiles of `tile` keys that hold an allowed key for some query row,
    dealt out in runs of ceil(tiles / splits); a split may be empty."""
    off = Sk - Sq
    klo, khi = 0, Sk - 1
    if causal:
        khi = min(khi, Sq - 1 + off)
    if window and window > 0:
        klo = max(klo, off - window + 1)
    lo = hi = 0
    if khi >= klo:
        lo, hi = klo // tile, khi // tile + 1
    per = -(-(hi - lo) // splits)
    return [(min(Sk, (lo + c * per) * tile),
             min(Sk, min(hi, lo + (c + 1) * per) * tile))
            for c in range(splits)]


def flash_attention_split_ref(q, k, v, *, causal=True, window=0,
                              softcap=0.0, scale=None, splits, tile):
    """The attention decode kernel's algorithm: one partial (running max m,
    sum l, unnormalised O) per key split of `split_key_ranges`, then the
    log-sum-exp merge O = sum_i O_i e^(m_i - M) / sum_i l_i e^(m_i - M),
    M = max_i m_i; a split with no allowed key adds nothing, a row with
    none gives 0. fp32; same arguments and result as
    `flash_attention_ref`."""
    s = _scores(q, k, causal=causal, window=window, softcap=softcap,
                scale=scale)
    G = q.shape[0] // k.shape[0]
    vf = v.float().repeat_interleave(G, dim=0)
    BH, Sq, hd = q.shape
    ms, ls, os = [], [], []
    for a, b in split_key_ranges(Sq, k.shape[1], causal=causal,
                                 window=window, splits=splits, tile=tile):
        part = s[..., a:max(a, b)]
        m = (part.amax(-1, keepdim=True) if part.shape[-1]
             else s.new_full((BH, Sq, 1), -torch.inf))
        p = torch.exp(part - torch.where(torch.isinf(m), 0.0, m))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        os.append(p @ vf[:, a:max(a, b)])
    M = torch.stack(ms).amax(0)
    f = [torch.exp(m - torch.where(torch.isinf(M), 0.0, M)) for m in ms]
    L = sum(li * fi for li, fi in zip(ls, f))
    O = sum(oi * fi for oi, fi in zip(os, f))
    out = torch.where(L > 0, O / torch.where(L > 0, L, 1.0), 0.0)
    return out.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, g, *, causal=True, window=0,
                            softcap=0.0, scale=None, lse=None):
    """Plain version of the attention backward kernel: the cotangents
    (dq, dk, dv) of `flash_attention_ref`'s inputs for the cotangent g of
    its output `out`, by the flash algorithm in fp32: each row's
    logsumexp (`lse` (BH, Sq) as the forward saved it, if given),
    D = rowsum(g * out), P recomputed, dV = P^T g, dP = g V^T,
    dS = P (dP - D) times the softcap's 1 - tanh^2, dQ = scale dS K,
    dK = scale dS^T Q; dK and dV summed over each GQA group of query
    heads. A row with no allowed key passes nothing back. Each gradient
    in its input's dtype."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    G = BH // BKV
    scale = (hd ** -0.5) if scale is None else scale
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    fac = None
    if softcap and softcap > 0:
        t = torch.tanh(s / softcap)
        s, fac = softcap * t, 1.0 - t * t
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~mask, -torch.inf)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        lse = torch.where(torch.isinf(lse), 0.0, lse)
    else:
        lse = lse.float()[..., None]
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (gf * out.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    ds = p * (torch.einsum("bqd,bkd->bqk", gf, vf) - delta)
    if fac is not None:
        ds = ds * fac
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dk = dk.view(BKV, G, Sk, hd).sum(1)
    dv = dv.view(BKV, G, Sk, hd).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mamba_scan_ref(x, dt, A, Bs, Cs, h0=None, chunk=None):
    """Sequential selective-scan oracle.
    x/dt: (B, S, di); Bs/Cs: (B, S, N); A: (di, N); h0: (B, di, N).
    Returns (y (B, S, di), h_last (B, di, N)), fp32; given `chunk`, also
    the states before steps 0, chunk, 2 chunk, ... (B, ceil(S / chunk),
    di, N): what the scan kernel keeps for its backward."""
    B, S, di = x.shape
    A = A.float()
    # the steps' slices as views from one unbind each: under autograd
    # their gradients are stacked once, not added into a zeroed (B, S, ...)
    # tensor at every step
    xs, dts, Bs_, Cs_ = (t.float().unbind(1) for t in (x, dt, Bs, Cs))
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys, kept = [], []
    for t in range(S):
        if chunk is not None and t % chunk == 0:
            kept.append(h)
        a = torch.exp(dts[t][..., None] * A)                  # (B, di, N)
        b = (dts[t] * xs[t])[..., None] * Bs_[t][:, None, :]
        h = a * h + b
        ys.append(torch.einsum("bdn,bn->bd", h, Cs_[t]))
    if chunk is None:
        return torch.stack(ys, dim=1), h
    return torch.stack(ys, dim=1), h, torch.stack(kept, dim=1)


def mamba_scan_bwd_ref(x, dt, A, Bs, Cs, D, h0, gy, gh, states=None,
                       chunk=16):
    """Plain version of the scan backward kernel: the cotangents of
    `mamba_scan_ref`'s inputs, plus the skip term's (y + x·D with D
    given), for the cotangents gy (B, S, di) of y and gh (B, di, N) of
    h_last, either of which may be None (no cotangent). The states are
    recomputed from h0 or, given `states` (B, ceil(S / chunk), di, N) as
    `mamba_scan_ref(chunk=chunk)` keeps them (16: the scan kernels'
    chunk), each chunk from its own state, as the kernel does; then a reverse loop in time carries dh
    back: dh += gy_t C_t, dC_t = Σ_d gy_t h_t, dB_t = Σ_d dh (dt_t x_t),
    d(dt·A) = dh h_{t-1} a_t, dh *= a_t. Returns (dx, ddt, dA, dB, dC, dD,
    dh0), fp32; dD None without D, dh0 None without h0."""
    B, S, di = x.shape
    A = A.float()
    xs, dts, Bs_, Cs_ = (t.float().unbind(1) for t in (x, dt, Bs, Cs))
    gys = None if gy is None else gy.float().unbind(1)
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    hs, decays = [h], []
    for t in range(S):
        if states is not None and t % chunk == 0:
            h = states[:, t // chunk].float()
            hs[-1] = h
        a = torch.exp(dts[t][..., None] * A)
        h = a * h + (dts[t] * xs[t])[..., None] * Bs_[t][:, None, :]
        hs.append(h)
        decays.append(a)
    dh = torch.zeros_like(h) if gh is None else gh.float()
    dA = torch.zeros_like(A)
    dx, ddt, dB, dC = [None] * S, [None] * S, [None] * S, [None] * S
    for t in reversed(range(S)):
        if gys is not None:
            dh = dh + gys[t][..., None] * Cs_[t][:, None, :]
            dC[t] = torch.einsum("bdn,bd->bn", hs[t + 1], gys[t])
        else:
            dC[t] = torch.zeros_like(Cs_[t])
        dB[t] = torch.einsum("bdn,bd->bn", dh, dts[t] * xs[t])
        u = torch.einsum("bdn,bn->bd", dh, Bs_[t])       # d(dt_t x_t)
        g_dta = dh * hs[t] * decays[t]                   # d(dt_t A)
        ddt[t] = u * xs[t] + torch.einsum("bdn,dn->bd", g_dta, A)
        dx[t] = u * dts[t]
        dA = dA + torch.einsum("bdn,bd->dn", g_dta, dts[t])
        dh = dh * decays[t]
    dx, ddt = torch.stack(dx, 1), torch.stack(ddt, 1)
    dD = None
    if D is not None:
        if gy is None:
            dD = torch.zeros_like(D, dtype=torch.float32)
        else:
            dx = dx + gy.float() * D.float()
            dD = (gy.float() * x.float()).sum((0, 1))
    return (dx, ddt, dA, torch.stack(dB, 1), torch.stack(dC, 1), dD,
            None if h0 is None else dh)


def mamba_scan_lanes_ref(x, dt, A, Bs, Cs, *, lanes):
    """The scan kernel's order of sums: the N states of a channel are split
    over `lanes` lanes, N / lanes consecutive states each; a lane sums its
    states' C_t[n]·h_t[n] in order, and the lanes' partial sums are added
    pairwise, lane l with lane l + lanes/2 first, then l + lanes/4, ...
    (the kernel's reduce-scatter). The recurrence itself is the sequential
    one of `mamba_scan_ref`. Returns y (B, S, di), fp32."""
    B, S, di = x.shape
    N = A.shape[1]
    if lanes < 1 or N % lanes or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two dividing N={N}, "
                         f"got {lanes}")
    A = A.float()
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bs.float(), Cs.float()
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * A) * h \
            + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        terms = (h * Cf[:, t, None, :]).reshape(B, di, lanes, N // lanes)
        part = terms[..., 0]
        for j in range(1, N // lanes):
            part = part + terms[..., j]
        while part.shape[-1] > 1:
            half = part.shape[-1] // 2
            part = part[..., :half] + part[..., half:]
        ys.append(part[..., 0])
    return torch.stack(ys, dim=1)


def _children(h, idx):
    """h[b, idx[b, n]] for (B, N, D) h; an index outside [0, N) reads a
    zero row, as the one-hot form does."""
    N = h.shape[1]
    ok = ((idx >= 0) & (idx < N)).unsqueeze(-1)
    rows = idx.clamp(0, N - 1).long().unsqueeze(-1).expand(-1, -1, h.shape[-1])
    return torch.where(ok, torch.gather(h, 1, rows), 0.0)


def tree_layer(h, left, right, m, wr, wl, wrt, b):
    """One tree-conv layer on masked (B, N, D) h with (B, N, 1) mask m."""
    out = (h @ wr + _children(h, left) @ wl + _children(h, right) @ wrt + b)
    return F.leaky_relu(out, 0.01) * m


def tree_conv_batch_ref(feat, left, right, mask, wr, wl, wrt, b):
    """Plain version of the `tree_conv` kernel: (B, N, F) -> (B, N, H)."""
    m = mask.unsqueeze(-1)
    return tree_layer(feat * m, left, right, m, wr, wl, wrt, b)


def tree_cnn_fused_ref(feat, left, right, mask, params):
    """Plain version of the `tree_cnn_fused` kernel: three layers, a
    residual on the third and a masked max-pool (all-masked -> 0);
    (B, N, F) -> (B, H)."""
    m = mask.unsqueeze(-1)

    def layer(h, p):
        return tree_layer(h, left, right, m, p["wr"], p["wl"], p["wrt"],
                          p["b"])

    h1 = layer(feat * m, params["conv1"])
    h2 = layer(h1, params["conv2"])
    h3 = layer(h2, params["conv3"]) + h2
    pooled = torch.where(m > 0, h3, -torch.inf).amax(dim=1)
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


def tree_cnn_fused_bwd_ref(feat, left, right, mask, params, g):
    """Plain version of the `tree_cnn_fused` backward kernel: the
    cotangents of `tree_cnn_fused_ref`'s inputs for the output cotangent
    g (B, H). Returns (gfeat (B, N, F), gmask (B, N), gparams with the
    params' nesting). The max-pool's gradient splits evenly among tied
    maxima and an all-masked tree passes none back; leaky_relu's
    gradient is 0.01 at exactly 0."""
    with torch.enable_grad():
        f = feat.detach().requires_grad_(True)
        m = mask.detach().requires_grad_(True)
        p = {l: {w: t.detach().requires_grad_(True) for w, t in ws.items()}
             for l, ws in params.items()}
        out = tree_cnn_fused_ref(f, left, right, m, p)
        names = [(l, w) for l in p for w in p[l]]
        grads = torch.autograd.grad(out, [f, m] + [p[l][w] for l, w in names],
                                    g)
    gparams = {l: {} for l in p}
    for (l, w), gw in zip(names, grads[2:]):
        gparams[l][w] = gw
    return grads[0], grads[1], gparams


def tree_conv_ref(feat, left, right, mask, wr, wl, wrt, b):
    """Neo-style tree convolution oracle.
    feat: (N, F); left/right: (N,) child indices (0 = null, row 0 zeroed);
    returns (N, H) leaky-relu activations, padding re-zeroed."""
    N = feat.shape[0]

    def rows(idx):                  # the reference's h[idx]: wrap, clamp
        idx = idx.long()
        return torch.where(idx < 0, idx + N, idx).clamp(0, N - 1)[None]

    return tree_conv_batch_ref(feat[None], rows(left), rows(right),
                               mask[None], wr, wl, wrt, b)[0]


# ------------------------------------------------------------------ threefry
# `jax.random` (jax 0.9.0, the partitionable Threefry-2x32 layout) on torch
# tensors: the plain version of the threefry kernel (csrc/threefry.cu).
# uint32 words live in int64 tensors, masked to 32 bits after every add and
# shift. Keys are (*lead, 2) int64 stacks, one draw a key; element i of a
# key's draw depends only on (key, i), so `offset` gives any slice alone.
_M32 = 0xFFFFFFFF


def threefry2x32_ref(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds, `core.prng`'s rotations) of counter
    (x0, x1) under key (k0, k1), elementwise over broadcast int64 tensors
    of uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ int(prng._PARITY))
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in prng._ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits_ref(keys, n, offset=0):
    """`jax.random.bits` (uint32, as int64): (*lead, n), elements
    [offset, offset + n) of each key's flat draw (`offset` an int, or a
    (*lead) int64 tensor: each key's own). The counter of element i is
    (i >> 32, i & 0xFFFFFFFF); the bits are the two output words xored."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device) \
        + torch.as_tensor(offset, dtype=torch.int64,
                          device=keys.device)[..., None]
    b0, b1 = threefry2x32_ref(keys[..., :1], keys[..., 1:], i >> 32, i & _M32)
    return b0 ^ b1


def _fma(a, b, c):
    """fp32 a * b + c rounded once, as a fused multiply-add. The product
    of two fp32 values is exact in fp64; the fp64 sum, cast to fp32, is
    the FMA's result unless the sum was rounded onto an fp32 midpoint
    (its low 29 bits 1000...0), where the cast would round a second time.
    There the sum's rounding error (TwoSum) moves it one fp64 ulp towards
    the exact value (the sum rounded to odd), and the cast rounds as the
    FMA would. Results are in fp32's normal range here."""
    p = a.double() * b
    s = p + c
    bits = s.view(torch.int64)
    tie = (bits & 0x1FFFFFFF) == 0x10000000
    if bool(tie.any()):
        c = c.double() if torch.is_tensor(c) else c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        toward = torch.where((err > 0) == (s > 0), 1, -1)
        s = torch.where(tie & (err != 0), bits + toward, bits).view(
            torch.float64)
    return s.float()


def random_uniform_ref(keys, n, minval, maxval, offset=0):
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, then one FMA
    by (maxval - minval) and minval (fp32 constants), then max(minval, .)."""
    bits = random_bits_ref(keys, n, offset)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    return torch.clamp_min(_fma(f, float(np.float32(maxval) - lo), float(lo)),
                           float(lo))


# XLA's CPU lowerings of log, log1p and erf_inv, with their fp32 constants.
# Cephes logf: the polynomial in x = m - 1 (its Horner split in three
# interleaved chains, as XLA emits it), and ln 2 as LN2_HI + LN2_LO
_LOG_P = np.array([7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                   -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                   2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1],
                  np.float32)
_LN2_LO, _LN2_HI = np.float32(-2.12194440e-4), np.float32(0.693359375)
_SQRT_HALF = np.float32(0.707106781186547524)
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


def _c(v):
    return float(np.float32(v))


def _div(a, b):
    """fp32 a / b correctly rounded: fp64's quotient rounded to fp32
    (torch's own fp32 division and square root on the CPU may be a vector
    library's, off by an ulp)."""
    return (a.double() / b.double()).float()


def _sqrt(x):
    """fp32 sqrt(x) correctly rounded, through fp64 as `_div`."""
    return torch.sqrt(x.double()).float()


def logf_ref(y):
    """XLA's CPU fp32 log of y (Cephes logf, FMAs where XLA fuses them)."""
    bits = torch.clamp_min(y, 2.0 ** -126).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _c(_SQRT_HALF)
    e = e - low.float()
    x = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = [_c(v) for v in _LOG_P]
    a = _fma(_fma(x, p[0], p[1]), x, p[2])
    b = _fma(_fma(x, p[3], p[4]), x, p[5])
    c = _fma(_fma(x, p[6], p[7]), x, p[8])
    a = _fma(_fma(_fma(a, x3, b), x3, c), x3, e * _c(_LN2_LO))
    out = _fma(e, _c(_LN2_HI), _fma(x2, -0.5, x) + a)
    out = torch.where(y < 0, torch.nan, out)
    out = torch.where(y == 0, -torch.inf, out)
    return torch.where(y == torch.inf, torch.inf, out)


def log1p_ref(x):
    """XLA's CPU fp32 log1p."""
    x2 = x * x
    num = torch.full_like(x, _c(_LOG1P_P[0]))
    for v in _LOG1P_P[1:]:
        num = _fma(num, x, _c(v))
    den = torch.ones_like(x)
    for v in _LOG1P_Q:
        den = _fma(den, x, _c(v))
    small = x + _fma(x2, -0.5, (x * x2) * _div(num, den))
    return torch.where(x.abs() < _c(0.41421356237309504880), small,
                       logf_ref(x + 1.0))


def erfinv32_ref(x):
    """`jax.lax.erf_inv` of fp32 x in [-1, 1] as XLA's CPU backend
    computes it (Giles' single-precision polynomials)."""
    w = -log1p_ref(-(x * x))
    lo = w < 5.0
    t = torch.where(lo, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lo, _c(_ERFINV_LO[0]), _c(_ERFINV_HI[0]))
    for a, b in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, t, torch.where(lo, _c(a), _c(b)))
    return torch.where(x.abs() == 1, x * torch.inf, p * x)


NORMAL_LO = np.nextafter(np.float32(-1), np.float32(0))
SQRT2 = _c(np.sqrt(2))


def random_normal_ref(keys, n, offset=0, stddev=1.0):
    """`stddev * jax.random.normal(key, shape, float32)`, elements
    [offset, offset + n) of each key's flat draw: sqrt(2) *
    erf_inv(uniform(nextafter(-1, 0), 1)), then the fp32 product by
    stddev, two roundings as the reference's `normal_init` makes them.
    `offset` and `stddev` may be (*lead) tensors, each key's own, so that
    the slices of many leaves are drawn in one call."""
    u = random_uniform_ref(keys, n, NORMAL_LO, 1.0, offset)
    scale = (torch.as_tensor(stddev).to(torch.float32)[..., None]
             if torch.is_tensor(stddev) else _c(stddev))
    return (SQRT2 * erfinv32_ref(u)) * scale


def random_gumbel_ref(keys, n, offset=0):
    """`jax.random.gumbel(key, shape, float32)` (mode "low"):
    -log(-log(uniform(tiny, 1)))."""
    return -logf_ref(-logf_ref(random_uniform_ref(keys, n, prng._TINY, 1.0,
                                                  offset)))
