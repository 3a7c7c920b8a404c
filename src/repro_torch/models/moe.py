"""FFN layers: gated-MLP and GShard-style capacity-factor MoE.

As the reference's `repro.models.moe`: tokens are *scattered* into an
(E, C, d_model) buffer at cumsum-derived positions-in-expert, the expert
matmuls run as one batched einsum, and results are gathered back and
combined with router weights. This is the reference's dispatch with no
sharding policy set (one device, global capacity slots; decode takes
every token). Its policy-driven dispatches (block-local, `shard_map`)
come with the port's sharding tooling.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (act_fn, apply_dense, init_dense,
                                       normal_init)


# ------------------------------------------------------------------ dense MLP
def init_mlp(gen, cfg, d_ff=None, *, lead=(), device):
    D, Fd = cfg.d_model, (d_ff or cfg.d_ff)
    kw = dict(lead=lead, device=device)
    p = {}
    p.update(init_dense(gen, D, Fd, cfg.pdtype, name="w_gate", **kw))
    p.update(init_dense(gen, D, Fd, cfg.pdtype, name="w_up", **kw))
    p.update(init_dense(gen, Fd, D, cfg.pdtype, name="w_down", **kw))
    return p


def apply_mlp(p, x, cfg):
    act = act_fn(cfg.act)
    g = act(apply_dense(p, x, "w_gate", cfg.cdtype))
    u = apply_dense(p, x, "w_up", cfg.cdtype)
    return apply_dense(p, g * u, "w_down", cfg.cdtype)


# ------------------------------------------------------------------ MoE
def init_moe(gen, cfg, *, lead=(), device):
    m = cfg.moe
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, m.n_experts
    kw = dict(device=device)
    p = {
        "router": normal_init(gen, (*lead, D, E), torch.float32, 0.02, **kw),
        "moe_wg": normal_init(gen, (*lead, E, D, Fd), cfg.pdtype, **kw),
        "moe_wu": normal_init(gen, (*lead, E, D, Fd), cfg.pdtype, **kw),
        "moe_wd": normal_init(gen, (*lead, E, Fd, D), cfg.pdtype, **kw),
    }
    if m.shared_expert_ff:
        p["shared"] = init_mlp(gen, cfg, d_ff=m.shared_expert_ff, lead=lead,
                               device=device)
    return p


def apply_moe(p, x, cfg):
    """x: (B, S, D). Returns (y, aux_metrics dict of scalar losses)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    T = B * S
    xt = x.reshape(T, D)
    act = act_fn(cfg.act)
    cdt = cfg.cdtype

    logits = xt.float() @ p["router"]                          # (T, E) fp32
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = route(probs, K)                               # (T, K)

    # decode (S == 1): no-drop, as the reference serves
    C = (T * K) if S == 1 else (int(m.capacity_factor * T * K / E) or 1)
    flat_e = eidx.reshape(-1)                                  # (T*K,) token-major
    xk = xt.repeat_interleave(K, dim=0).to(cdt)                # (T*K, D)
    onehot = F.one_hot(flat_e, E)                              # (T*K, E)
    pos = onehot.cumsum(0) - 1                                 # global slots
    pos_t = pos.gather(1, flat_e[:, None])[:, 0]
    keep = pos_t < C
    # a dropped token goes to slot C, which is cut off: no host sync
    buf = torch.zeros((E, C + 1, D), dtype=cdt, device=x.device)
    buf[flat_e, pos_t.clamp(max=C)] = xk
    buf = buf[:, :C]
    g = torch.einsum("ecd,edf->ecf", buf, p["moe_wg"].to(cdt))
    u = torch.einsum("ecd,edf->ecf", buf, p["moe_wu"].to(cdt))
    h = act(g) * u
    yb = torch.einsum("ecf,efd->ecd", h, p["moe_wd"].to(cdt))
    ytk = yb[flat_e, pos_t.clamp(max=C - 1)] * keep.to(cdt)[:, None]

    y = (ytk.reshape(T, K, D) * gate.to(cdt)[..., None]).sum(dim=1)

    aux = _aux_losses(m, logits, probs, eidx)
    y = y.reshape(B, S, D)
    if m.shared_expert_ff:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux


def route(probs, K):
    """Each token's top-K experts (T, K) and their gates, renormalised."""
    gate, eidx = torch.topk(probs, K, dim=-1)
    return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _aux_losses(m, logits, probs, eidx):
    """GShard load-balance + router z-loss."""
    E = m.n_experts
    me = probs.mean(0)                                         # (E,)
    frac = F.one_hot(eidx[:, 0], E).float().mean(0)
    return {
        "moe_aux": m.aux_loss * E * (me * frac).sum(),
        "moe_z": m.router_z_loss * torch.logsumexp(logits, -1).square().mean(),
    }
