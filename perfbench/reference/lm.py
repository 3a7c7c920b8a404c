"""The plain reference of the benchmark's training cells: the language
model's loss in float32 PyTorch, written from the layer equations alone.

It imports nothing of the program under test. It reads a configuration
file's sizes (`perfbench/configs/<name>.json`) and a flat dict of
parameters named as the program's tree names them ("stack/layer0/mixer/wq",
each stacked on a leading layer axis), which the benchmark draws from the
seed and hands to both sides. Every product runs in float32 with TF32 off
(`strict_float32`), unless `prec` is "fp8": then each product's two
operands are first rounded to float8 e4m3 under a per-tensor scale, the
control that a check must refuse.

Layers:

  * attention: RMSNorm, q/k/v projections with their biases where the
    configuration has them, rotary embedding (half-split pairs), causal
    softmax attention over grouped kv heads, the output projection;
  * MLP: SiLU(x Wg) * (x Wu) Wd;
  * Mamba-1: in-projection to (x, z), a depthwise causal conv with bias,
    SiLU, the x-projection to (dt, B, C), dt = softplus(dt Wdt + b), the
    selective scan h_t = exp(dt A) h_{t-1} + dt x B_t, y = C h + D x,
    y * SiLU(z), the out-projection; the scan and its backward are
    computed in chunks of `SCAN_CHUNK` steps (`linear_scan`), each in
    closed form, one chunk after the other;
  * MoE (GShard-style, capacity-factor dispatch): an fp32 router over all
    experts, each token's top-k renormalised, the assignments of token t
    at flat index t * k + j, each expert keeping the first
    int(cf * T * k / E) of its assignments in that order; the experts
    this process holds computed for their kept tokens, weighted by the
    gates; across processes their outputs summed (`ranks`); the
    load-balance and router z losses added to the loss;
  * the head: final RMSNorm, logits against the head (or the embedding
    when tied), next-token cross-entropy averaged over the mask.

Each layer runs under a checkpoint, attention a block of query rows at a
time under checkpoints of its own and the scan a block of channels at a
time, recomputed in its backward, so that a whole model's float32 gradient
fits beside its AdamW state.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NORM_EPS = 1e-6
ATTN_ROWS = 1024        # query rows of attention computed at once
SCAN_CHUNK = 16         # steps of the scan in closed form at once
SCAN_CHANNELS = 2048    # channels of the scan computed at once
CE_ROWS = 2048          # tokens of the loss computed at once
FP8_MAX = 448.0         # the largest float8 e4m3 value


@contextlib.contextmanager
def strict_float32():
    """float32 products as float32: TF32 off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def operand(t, prec):
    """A product's operand in `prec`: itself ("fp32"), or rounded to
    float8 e4m3 under the scale that maps its largest magnitude to 448
    ("fp8")."""
    if prec == "fp32":
        return t
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    if t.numel() == 0:
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t / scale).to(torch.float8_e4m3fn).float()
    # the rounding's gradient passes straight through
    return t + (q * scale - t).detach()


def mm(a, b, prec):
    return operand(a, prec) @ operand(b, prec)


def rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + NORM_EPS) \
        * scale


def rope(x, theta):
    """x: (B, S, H, hd), positions 0..S-1; pairs (i, i + hd/2)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_rows(q, k, v, a, prec):
    """Causal attention of query rows [a, a + q.shape[2]) against keys
    [0, a + rows): q (B, H, R, hd), k/v (B, H, S, hd)."""
    R, hd = q.shape[2], q.shape[3]
    k, v = k[:, :, :a + R], v[:, :, :a + R]
    s = mm(q, k.transpose(-1, -2), prec) * hd ** -0.5
    qpos = torch.arange(a, a + R, device=q.device)[:, None]
    kpos = torch.arange(a + R, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v, prec)


def attention(q, k, v, prec):
    """q (B, S, H, hd), k/v (B, S, K, hd) with H a multiple of K; query
    head h reads kv head h // (H / K). Returns (B, S, H, hd)."""
    G = q.shape[2] // k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    S = q.shape[2]
    out = [checkpoint(_attn_rows, q[:, :, a:a + ATTN_ROWS], k, v, a, prec,
                      use_reentrant=False)
           for a in range(0, S, ATTN_ROWS)]
    return torch.cat(out, dim=2).transpose(1, 2)


def dense(p, x, name, prec):
    y = mm(x, p[name], prec)
    return y + p[name + "_bias"] if name + "_bias" in p else y


def attention_block(p, h, cfg, prec):
    B, S, _ = h.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = dense(p, h, "wq", prec).reshape(B, S, H, hd)
    k = dense(p, h, "wk", prec).reshape(B, S, K, hd)
    v = dense(p, h, "wv", prec).reshape(B, S, K, hd)
    if cfg.get("rope", True):
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    out = attention(q, k, v, prec).reshape(B, S, H * hd)
    return mm(out, p["wo"], prec)


def mlp(p, h, prec):
    return mm(F.silu(mm(h, p["w_gate"], prec)) * mm(h, p["w_up"], prec),
              p["w_down"], prec)


# ------------------------------------------------------------------ Mamba
def linear_scan(a_log, b, reverse=False):
    """h_t = exp(a_log_t) h_{t-1} + b_t along dim 1 of (B, S, c, N)
    tensors from h_{-1} = 0 (with `reverse`, from the last step back).
    Inside a chunk of SCAN_CHUNK steps in closed form, h_t = exp(s_t) (h_in
    + sum_{u <= t} exp(-s_u) b_u) with s the chunk's running sum of a_log
    (|s| stays far below float32's exp range: a step's |a_log| is dt |A|),
    then chunk after chunk, each from the last one's final state."""
    if reverse:
        return linear_scan(a_log.flip(1), b.flip(1)).flip(1)
    B, S, c, N = b.shape
    L = SCAN_CHUNK
    pad = (-S) % L
    if pad:
        a_log = F.pad(a_log, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L
    s = torch.cumsum(a_log.reshape(B, nc, L, c, N), dim=2)
    decay = torch.exp(s)
    h = torch.cumsum(torch.exp(-s) * b.reshape(B, nc, L, c, N), dim=2)
    h.mul_(decay)
    del s
    for j in range(1, nc):
        h[:, j].addcmul_(decay[:, j], h[:, j - 1, -1:])
    if not torch.isfinite(h).all():
        raise FloatingPointError("the scan left float32's range")
    return h.reshape(B, nc * L, c, N)[:, :S]


class _Scan(torch.autograd.Function):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from a
    zero state: x, dt (B, S, c); A (c, N); Bm, Cm (B, S, N). The backward
    recomputes h and runs the cotangent's recurrence in reverse,
    g_t = C_t gy_t + exp(dt_{t+1} A) g_{t+1}."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        h = linear_scan(dt[..., None] * A, (dt * x)[..., None]
                        * Bm[:, :, None, :])
        return torch.einsum("bscn,bsn->bsc", h, Cm)

    @staticmethod
    def backward(ctx, gy):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        a_log = dt[..., None] * A
        h = linear_scan(a_log, (dt * x)[..., None] * Bm[:, :, None, :])
        gC = torch.einsum("bscn,bsc->bsn", h, gy)
        nxt = torch.cat([a_log[:, 1:], torch.zeros_like(a_log[:, :1])], 1)
        g = linear_scan(nxt, gy[..., None] * Cm[:, :, None, :],
                        reverse=True)                  # dL/dh_t
        del nxt
        gb = g * Bm[:, :, None, :]                     # dL/db_t / dt x
        # dL/da_log_t = g_t a_t h_{t-1}
        h = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        ga = g * torch.exp(a_log) * h
        del h, a_log
        sb = gb.sum(-1)
        gx = dt * sb
        gdt = x * sb + (ga * A).sum(-1)
        gB = (g * (dt * x)[..., None]).sum(2)
        gA = (ga * dt[..., None]).sum((0, 1))
        return gx, gdt, gA, gB, gC


def selective_scan(x, dt, A, Bm, Cm, D):
    """y = C h + D x, `SCAN_CHANNELS` channels at a time."""
    ys = [_Scan.apply(x[..., a:a + SCAN_CHANNELS],
                      dt[..., a:a + SCAN_CHANNELS], A[a:a + SCAN_CHANNELS],
                      Bm, Cm)
          for a in range(0, x.shape[-1], SCAN_CHANNELS)]
    return torch.cat(ys, dim=-1) + x * D


def mamba_block(p, h, cfg, prec):
    S = h.shape[1]
    N, R = cfg["d_state"], cfg["dt_rank"]
    xin, z = mm(h, p["mamba_in"], prec).chunk(2, dim=-1)
    w = p["mamba_conv_w"]                                # (W, d_inner)
    W = w.shape[0]
    xp = F.pad(xin, (0, 0, W - 1, 0))
    xc = sum(xp[:, i:i + S] * w[i] for i in range(W)) + p["mamba_conv_b"]
    xa = F.silu(xc)
    dt_in, Bm, Cm = mm(xa, p["mamba_xproj"], prec).split([R, N, N], dim=-1)
    dt = F.softplus(mm(dt_in, p["mamba_dtproj"], prec)
                    + p["mamba_dtproj_bias"])
    A = -torch.exp(p["mamba_A_log"])
    y = selective_scan(xa, dt, A, Bm, Cm, p["mamba_D"])
    return mm(y * F.silu(z), p["mamba_out"], prec)


# ------------------------------------------------------------------ MoE
class _SumRanks(torch.autograd.Function):
    """The sum of every process's tensor; the cotangent passes through."""
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A tensor every process holds alike, fed to each process's share of
    the work: itself forward, its cotangents summed over the processes."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def route(logits, k):
    """Each token's top-k experts and their gates, renormalised."""
    gate, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx


def moe_block(p, h, cfg, prec, ranks, exchange=True):
    """Returns (y, aux loss). `ranks`: None (every expert here) or (group,
    first expert held); p's expert leaves hold this process's experts.
    exchange=False: a fault, the sum over the processes left out."""
    B, S, D = h.shape
    E, K = cfg["n_experts"], cfg["top_k"]
    x = h.reshape(B * S, D)
    T = x.shape[0]
    logits = x @ p["router"]                 # the router is float32 as run
    probs = torch.softmax(logits, dim=-1)
    gate, idx = route(logits, K)
    aux = cfg["aux_loss"] * E * (probs.mean(0) * F.one_hot(
        idx[:, 0], E).float().mean(0)).sum() \
        + cfg["router_z_loss"] * torch.logsumexp(logits, -1).square().mean()
    cap = max(int(cfg["capacity_factor"] * T * K / E), 1)
    e0 = 0 if ranks is None else ranks[1]
    if ranks is not None:
        x, gate = _Replicated.apply(x, ranks[0]), _Replicated.apply(
            gate, ranks[0])
    flat_e, flat_g = idx.reshape(-1), gate.reshape(-1)
    y = torch.zeros_like(x)
    for j in range(p["moe_wg"].shape[0]):
        kept = torch.nonzero(flat_e == e0 + j)[:cap, 0]
        tok = kept // K
        xe = x[tok]
        ye = mm(F.silu(mm(xe, p["moe_wg"][j], prec))
                * mm(xe, p["moe_wu"][j], prec), p["moe_wd"][j], prec)
        y = y.index_add(0, tok, ye * flat_g[kept][:, None])
    if ranks is not None and exchange:
        y = _SumRanks.apply(y, ranks[0])
    return y.reshape(B, S, D), aux


# ------------------------------------------------------------------ model
def _layer(p, x, spec, cfg, prec, ranks, exchange):
    aux = torch.zeros((), device=x.device)
    h = rmsnorm(x, p["norm1/scale"])
    if spec["mixer"] == "mamba":
        x = x + mamba_block(_sub(p, "mixer/"), h, cfg, prec)
    else:
        x = x + attention_block(_sub(p, "mixer/"), h, cfg, prec)
    if spec["ffn"] != "none":
        h = rmsnorm(x, p["norm2/scale"])
        if spec["ffn"] == "moe":
            f, aux = moe_block(_sub(p, "ffn/"), h, cfg, prec, ranks,
                               exchange)
        else:
            f = mlp(_sub(p, "ffn/"), h, prec)
        x = x + f
    return x, aux


def _sub(p, prefix):
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _ce_rows(xn, w, tgt, mask, prec):
    lg = mm(xn, w, prec)
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, tgt[:, None])[:, 0]
    return (nll * mask).sum()


def loss(params, tokens, mask, cfg, prec="fp32", ranks=None,
         exchange=True):
    """Mean next-token cross-entropy over the mask plus the MoE losses.
    params: {path: float32 tensor}; tokens (B, S) int; mask (B, S);
    `ranks` and `exchange` as `moe_block` takes them."""
    x = params["embed"][tokens.long()]
    layers = {}
    for path, t in params.items():
        if path.startswith("stack/"):
            _, lay, rest = path.split("/", 2)
            layers.setdefault(lay, {})[rest] = t.unbind(0)
    pattern = cfg["layers"]
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["n_layers"] // len(pattern)):
        for j, spec in enumerate(pattern):
            p = {k: v[i] for k, v in layers[f"layer{j}"].items()}
            x, a = checkpoint(_layer, p, x, spec, cfg, prec, ranks,
                              exchange, use_reentrant=False)
            aux = aux + a
    xn = rmsnorm(x[:, :-1], params["final_norm/scale"])
    w = params["embed"].T if cfg["tie_embeddings"] else params["lm_head"]
    D = xn.shape[-1]
    xn = xn.reshape(-1, D)
    tgt = tokens[:, 1:].reshape(-1).long()
    m = mask[:, 1:].reshape(-1).float()
    tot = sum(checkpoint(_ce_rows, xn[a:a + CE_ROWS], w, tgt[a:a + CE_ROWS],
                         m[a:a + CE_ROWS], prec, use_reentrant=False)
              for a in range(0, xn.shape[0], CE_ROWS))
    return tot / m.sum().clamp_min(1.0) + aux
