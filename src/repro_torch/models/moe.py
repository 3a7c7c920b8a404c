"""FFN layers: gated-MLP and GShard-style capacity-factor MoE.

As the reference's `repro.models.moe`: tokens are *scattered* into an
(E, C, d_model) buffer at cumsum-derived positions-in-expert, the expert
matmuls run as one batched einsum, and results are gathered back and
combined with router weights. With no sharding policy set this is the
reference's global dispatch (global capacity slots; decode takes every
token). The policy's `moe_dispatch` picks the reference's two others:

  * "local": the block-local dispatch. The T*K assignments are cut into
    NB = 32 blocks, each with its own capacity slice (`_dispatch_local`);
  * "shard_map": the reference's explicit per-shard dispatch over the
    policy's dp x tp mesh, emulated on one device (`_dispatch_sharded`):
    each dp shard's tokens meet each tp shard's E/tp experts with that
    shard's own capacity, and the tp shards' partial outputs are summed
    where the reference calls psum. Its numbers are those of the
    reference's sharded program at that mesh, capacity drops included.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (act_fn, apply_dense, init_dense,
                                       normal_init)
from repro_torch.sharding import act as act_sharding

LOCAL_BLOCKS = 32      # the block-local dispatch's blocks (>= dp x pod)


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

    pol = act_sharding.current()
    mode = pol.moe_dispatch if pol is not None and S > 1 else "global"
    if mode == "shard_map" and pol.mesh is not None:
        y = _dispatch_sharded(xt, eidx, gate, p, cfg, pol, act)
    else:
        xk = xt.repeat_interleave(K, dim=0).to(cdt)            # (T*K, D)
        if mode == "local" and (T * K) % LOCAL_BLOCKS == 0:
            ytk = _dispatch_local(xk, eidx.reshape(-1), p, cfg, act)
        else:
            ytk = _dispatch_global(xk, eidx.reshape(-1), p, cfg, act,
                                   decode=S == 1)
        y = (ytk.reshape(T, K, D) * gate.to(cdt)[..., None]).sum(dim=1)

    aux = _aux_losses(m, logits, probs, eidx)
    y = y.reshape(B, S, D)
    if m.shared_expert_ff:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux


def _experts(buf, p, cdt, act, lead: str):
    """The expert MLPs on a capacity buffer (..., E, C, D): one batched
    einsum a weight. `lead` names buf's dims before the expert dim."""
    g = torch.einsum(f"{lead}ecd,edf->{lead}ecf", buf, p["moe_wg"].to(cdt))
    u = torch.einsum(f"{lead}ecd,edf->{lead}ecf", buf, p["moe_wu"].to(cdt))
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", act(g) * u,
                        p["moe_wd"].to(cdt))


def _dispatch_global(xk, flat_e, p, cfg, act, *, decode):
    """The paper-era global dispatch: one (E, C, D) buffer over every
    token's global capacity slot. Decode (S == 1) is no-drop, as the
    reference serves. Returns the (T*K, D) expert outputs, dropped ones
    0."""
    m, cdt = cfg.moe, cfg.cdtype
    E, TK, D = m.n_experts, xk.shape[0], xk.shape[1]
    C = TK if decode else (int(m.capacity_factor * TK / E) or 1)
    onehot = one_hot(flat_e, E)                              # (T*K, E)
    pos = onehot.cumsum(0) - 1                                 # global slots
    pos_t = pos.gather(1, flat_e[:, None])[:, 0]
    keep = pos_t < C
    # a dropped token goes to slot C, which is cut off: no host sync
    buf = torch.zeros((E, C + 1, D), dtype=cdt, device=xk.device)
    buf[flat_e, pos_t.clamp(max=C)] = xk
    yb = _experts(buf[:, :C], p, cdt, act, "")
    return yb[flat_e, pos_t.clamp(max=C - 1)] * keep.to(cdt)[:, None]


def _dispatch_local(xk, flat_e, p, cfg, act):
    """The reference's block-local dispatch: the T*K assignments in
    LOCAL_BLOCKS blocks, each with its own capacity slice of Cb slots, so
    that the scatter is local to a block. Returns the (T*K, D) expert
    outputs, dropped ones 0."""
    m, cdt = cfg.moe, cfg.cdtype
    E, D = m.n_experts, xk.shape[1]
    NB = LOCAL_BLOCKS
    Tb = xk.shape[0] // NB
    Cb = max(int(m.capacity_factor * Tb / E), 1)
    eb = flat_e.reshape(NB, Tb)
    pos = one_hot(eb, E).cumsum(1) - 1                       # block-local
    pos_t = pos.gather(2, eb[..., None])[..., 0]
    keep = pos_t < Cb
    bidx = torch.arange(NB, device=xk.device)[:, None].expand(NB, Tb)
    buf = torch.zeros((NB, E, Cb + 1, D), dtype=cdt, device=xk.device)
    buf[bidx, eb, pos_t.clamp(max=Cb)] = xk.reshape(NB, Tb, D)
    yb = _experts(buf[:, :, :Cb], p, cdt, act, "b")
    ytk = yb[bidx, eb, pos_t.clamp(max=Cb - 1)] * keep.to(cdt)[..., None]
    return ytk.reshape(NB * Tb, D)


def _dispatch_sharded(xt, eidx, gate, p, cfg, pol, act):
    """The reference's `shard_map` dispatch over the policy's dp x tp
    mesh, on one device. The reference shards the tokens over dp and the
    experts over tp; each (dp, tp) shard scatters its tokens' assignments
    to its own E/tp experts into a (E/tp, Cl, D) buffer with its own
    capacity Cl = cf * T_l * K / E (T_l = T / dp), runs them, gathers the
    outputs back to its tokens (0 for another shard's expert or a drop)
    and sums its top-k partials; a psum over tp then adds the tp shards'.
    Here the dp shards are a leading batch dim and the tp shards a loop,
    summed in order. Returns y (T, D)."""
    m, cdt = cfg.moe, cfg.cdtype
    E, K, D = m.n_experts, m.top_k, cfg.d_model
    dp, tp = pol.dp_size, pol.tp_size
    T = xt.shape[0]
    if T % dp or E % tp:
        raise ValueError(f"shard_map dispatch needs T={T} divisible by "
                         f"dp={dp} and E={E} by tp={tp}")
    El, Tl = E // tp, T // dp
    Cl = max(int(m.capacity_factor * Tl * K / E), 1)
    xk = xt.to(cdt).repeat_interleave(K, dim=0).reshape(dp, Tl * K, D)
    e_l = eidx.reshape(dp, Tl * K)
    g_l = gate.to(cdt).reshape(dp, Tl, K)
    sidx = torch.arange(dp, device=xt.device)[:, None].expand(dp, Tl * K)
    parts = []
    for j in range(tp):
        fe = e_l - j * El                             # local expert index
        mine = (fe >= 0) & (fe < El)
        fe_c = fe.clamp(0, El - 1)
        onehot = one_hot(fe_c, El) * mine[..., None]
        pos_t = (onehot.cumsum(1) - 1).gather(2, fe_c[..., None])[..., 0]
        keep = mine & (pos_t < Cl)
        # a foreign or dropped assignment goes to expert row El, cut off
        buf = torch.zeros((dp, El + 1, Cl, D), dtype=cdt, device=xt.device)
        buf[sidx, torch.where(keep, fe_c, El),
            torch.where(keep, pos_t, 0)] = xk
        w = {n: p[n][j * El:(j + 1) * El] for n in ("moe_wg", "moe_wu",
                                                   "moe_wd")}
        yb = _experts(buf[:, :El], w, cdt, act, "s")
        ytk = (yb[sidx, fe_c, pos_t.clamp(max=Cl - 1)]
               * keep.to(cdt)[..., None])
        parts.append((ytk.reshape(dp, Tl, K, D) * g_l[..., None]).sum(2))
    y = parts[0]
    for part in parts[1:]:                            # the psum over tp
        y = y + part
    return y.reshape(T, D)


def one_hot(idx, n):
    """`F.one_hot` (int64), by one comparison: the same ops on every
    device, where `F.one_hot` takes a device-dependent path (a range
    check that reads the data on the CPU), so that an op count on `meta`
    is the card's."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def route(probs, K):
    """Each token's top-K experts (T, K) and their gates, renormalised."""
    gate, eidx = torch.topk(probs, K, dim=-1)
    return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _aux_losses(m, logits, probs, eidx):
    """GShard load-balance + router z-loss."""
    E = m.n_experts
    me = probs.mean(0)                                         # (E,)
    frac = one_hot(eidx[:, 0], E).float().mean(0)
    return {
        "moe_aux": m.aux_loss * E * (me * frac).sum(),
        "moe_z": m.router_z_loss * torch.logsumexp(logits, -1).square().mean(),
    }
