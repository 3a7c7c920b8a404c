"""Plain PyTorch versions of the kernels: what each kernel wrapper runs for
CPU tensors, and what the kernels are held to on the card. They run on
any device.

`flash_attention_ref`, `mamba_scan_ref` and `tree_conv_ref` keep the
reference oracles' signatures and semantics (the allclose ground truth);
`flash_attention_ref` also takes GQA k/v, as the kernel does.
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

import torch
import torch.nn.functional as F


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """q: (BH, Sq, hd), k/v: (BKV, Sk, hd) with BH % BKV == 0; query row b
    reads k/v row b // (BH / BKV). fp32 softmax, full scores. Queries are
    right-aligned: qpos = i + Sk - Sq. Fully-masked rows -> 0. Returns
    (BH, Sq, hd) in q's dtype."""
    G = q.shape[0] // k.shape[0]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=0), v.repeat_interleave(G, dim=0)
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)   # fully-masked -> 0
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


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
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
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


def mamba_scan_ref(x, dt, A, Bs, Cs, h0=None):
    """Sequential selective-scan oracle.
    x/dt: (B, S, di); Bs/Cs: (B, S, N); A: (di, N); h0: (B, di, N).
    Returns (y (B, S, di), h_last (B, di, N)), fp32."""
    B, S, di = x.shape
    A = A.float()
    # the steps' slices as views from one unbind each: under autograd
    # their gradients are stacked once, not added into a zeroed (B, S, ...)
    # tensor at every step
    xs, dts, Bs_, Cs_ = (t.float().unbind(1) for t in (x, dt, Bs, Cs))
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(dts[t][..., None] * A)                  # (B, di, N)
        b = (dts[t] * xs[t])[..., None] * Bs_[t][:, None, :]
        h = a * h + b
        ys.append(torch.einsum("bdn,bn->bd", h, Cs_[t]))
    return torch.stack(ys, dim=1), h


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
