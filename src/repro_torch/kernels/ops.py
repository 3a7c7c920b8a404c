"""Model-layout wrappers over the kernels, as the reference's
`kernels/ops.py` has them. Each call launches its kernel once on CUDA
tensors and takes the kernel's plain version on CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.tree_conv import tree_conv


def mha_flash(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """Model-layout wrapper: q (B, Sq, H, hd), k/v (B, Sk, K, hd) GQA.
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * K, k.shape[1], hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * K, v.shape[1], hd).contiguous()
    out = flash_attention(qf, kf, vf, causal=causal, window=window,
                          softcap=softcap, scale=scale)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def selective_scan_fused(x, dt, A, Bs, Cs, D_skip, h0=None):
    """Mamba block core with `models.mamba.selective_scan`'s contract:
    (y + x * D_skip, h_last) in fp32, D_skip (di,), from the state h0
    (B, di, N) or zeros. One launch: the kernel adds the skip term as it
    writes y, and writes h_last after the last step."""
    return mamba_scan(x, dt, A, Bs, Cs, D=D_skip, h0=h0)


def tree_conv_batch(feat, left, right, mask, params):
    """AQORA TreeCNN layer: params {wr, wl, wrt, b} as in core.nets."""
    return tree_conv(feat, left, right, mask, params["wr"], params["wl"],
                     params["wrt"], params["b"])
