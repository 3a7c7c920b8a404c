"""Mamba-1 selective-SSM block (falcon-mamba / jamba mixer).

As the reference's `repro.models.mamba`, but the prefill's selective scan
is the port's `mamba_scan` kernel (`kernels.ops.selective_scan_fused`):
one launch per layer on the card, which takes the cache's state as h0 and
returns h_last for it; on CPU tensors the kernel's plain version,
sequential in time. The reference runs a chunked associative scan there,
the same recurrence summed in another order.

The decode path is the reference's O(1) recurrent update on (conv_state,
ssm_state), in torch ops. A cache is updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.common import (apply_dense, init_dense, normal_init,
                                       split_keys)


def init_mamba(key, cfg, *, device):
    s = cfg.ssm
    ks = split_keys(key, 8)
    lead = ks[0].shape[:-1]
    D, di, N, R = cfg.d_model, cfg.d_inner, s.d_state, cfg.dt_rank
    kw = dict(device=device)
    p = {}
    p.update(init_dense(ks[0], D, 2 * di, cfg.pdtype, name="mamba_in", **kw))
    p["mamba_conv_w"] = normal_init(ks[1], (s.d_conv, di), cfg.pdtype, 0.1,
                                    name="mamba_conv_w", **kw)
    p["mamba_conv_b"] = torch.zeros((*lead, di), dtype=cfg.pdtype,
                                    device=device)
    p.update(init_dense(ks[2], di, R + 2 * N, cfg.pdtype, name="mamba_xproj",
                        **kw))
    p.update(init_dense(ks[3], R, di, cfg.pdtype, bias=True,
                        name="mamba_dtproj", **kw))
    # S4D-real init for A: A_log = log(1..N) rows broadcast over d_inner,
    # with the reference's fp32 log (XLA's, which is not correctly rounded)
    a_log = ref.logf_ref(torch.arange(1, N + 1, dtype=torch.float32))
    p["mamba_A_log"] = torch.empty((*lead, di, N), dtype=torch.float32,
                                   device=device)
    if p["mamba_A_log"].device.type != "meta":
        p["mamba_A_log"].copy_(a_log.expand(*lead, di, N))
    p["mamba_D"] = torch.ones((*lead, di), dtype=torch.float32, device=device)
    p.update(init_dense(ks[4], di, D, cfg.pdtype, name="mamba_out", **kw))
    return p


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,di), w: (W,di). state: (B,W-1,di) or
    None. Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return y + b, new_state


def _ssm_params(p, x_act, cfg):
    """x_act: (B,S,di) -> dt (B,S,di), B_ssm/C_ssm (B,S,N), A (di,N) fp32."""
    s = cfg.ssm
    N, R = s.d_state, cfg.dt_rank
    proj = apply_dense(p, x_act, "mamba_xproj", cfg.cdtype)
    dt_in, Bs, Cs = proj.split([R, N, N], dim=-1)
    dt = F.softplus(apply_dense(p, dt_in, "mamba_dtproj", cfg.cdtype).float())
    A = -torch.exp(p["mamba_A_log"])
    return dt, Bs.float(), Cs.float(), A


def selective_scan(x, dt, A, Bs, Cs, D_skip, h0=None):
    """The selective-scan core. x/dt: (B,S,di), Bs/Cs: (B,S,N), A: (di,N),
    D_skip (di,), h0 (B,di,N) or None (zeros). Returns (y + x * D_skip
    (B,S,di), h_last (B,di,N)). All fp32 math, through the scan kernel."""
    def f32(t):
        return t.float().contiguous()
    return ops.selective_scan_fused(
        f32(x), f32(dt), f32(A), f32(Bs), f32(Cs), f32(D_skip),
        h0=None if h0 is None else f32(h0))


def apply_mamba(p, x, cfg, *, cache=None):
    """x: (B,S,D). cache: None or {"conv": (B,W-1,di), "ssm": (B,di,N)},
    updated in place. Returns out (B,S,D)."""
    S = x.shape[1]
    xz = apply_dense(p, x, "mamba_in", cfg.cdtype)
    xin, z = xz.chunk(2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xconv, new_conv = _causal_conv(xin, p["mamba_conv_w"].to(cfg.cdtype),
                                   p["mamba_conv_b"].to(cfg.cdtype),
                                   conv_state)
    xact = F.silu(xconv)
    dt, Bs, Cs, A = _ssm_params(p, xact, cfg)

    if cache is not None and S == 1:
        # O(1) recurrent decode step
        h = cache["ssm"].float()                              # (B,di,N)
        a = torch.exp(dt[:, 0, :, None] * A)                  # (B,di,N)
        b = (dt[:, 0] * xact[:, 0].float())[..., None] * Bs[:, 0, None, :]
        h = a * h + b
        y = torch.einsum("bdn,bn->bd", h, Cs[:, 0])[:, None, :]
        y = y + xact.float() * p["mamba_D"]
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, h = selective_scan(xact, dt, A, Bs, Cs, p["mamba_D"], h0=h0)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h)

    y = y.to(cfg.cdtype) * F.silu(z)
    return apply_dense(p, y, "mamba_out", cfg.cdtype)
