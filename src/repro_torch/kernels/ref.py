"""Plain PyTorch versions of the kernels: what each kernel wrapper runs for
CPU tensors, and what the kernels are held to on the card. They run on
any device.

`flash_attention_ref`, `mamba_scan_ref` and `tree_conv_ref` keep the
reference oracles' signatures and semantics (the allclose ground truth);
`flash_attention_ref` also takes GQA k/v, as the kernel does.
`tree_conv_batch_ref` and `tree_cnn_fused_ref` are the plain versions of
the two tree kernels. They read a zero row for a child index outside
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


def mamba_scan_ref(x, dt, A, Bs, Cs, h0=None):
    """Sequential selective-scan oracle.
    x/dt: (B, S, di); Bs/Cs: (B, S, N); A: (di, N); h0: (B, di, N).
    Returns (y (B, S, di), h_last (B, di, N)), fp32."""
    B, S, di = x.shape
    A = A.float()
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bs.float(), Cs.float()
    h = (torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * A)                 # (B, di, N)
        b = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = a * h + b
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


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
