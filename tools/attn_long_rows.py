"""How far layer 0's superblock of a train_lm cell lies from the plain
versions' when its attention runs through the kernels, and how far it
moves under other roundings of the same attention calls. Run from the
repository root on a machine with an NVIDIA H100:

    python3 tools/attn_long_rows.py [--arch gemma2-27b ...] [--seqs N ...]

For each arch it builds the cell of chip_smoke.py's TRAIN_LM_CELLS (its
layers, from prng_key(0)) and runs its first superblock forward and
backward on the first `seq` tokens (default: the cell's) of the cell's
first batch, with seeded frames at an enc-dec config
(`chip_smoke.seeded_batch`) and `chip_smoke.superblock0`'s fixed
cotangent, each of WAYS:

- plain, plain_again: the plain versions (fp32 inside, bf16 out);
- kernel: the kernels' autograd Functions;
- nudged: the plain versions with the scores' scale times 1 + NUDGE,
  which moves the fp32 output by ~1e-6 of itself: only a few of its
  roundings to bf16 flip, and no kernel runs;
- flash, emulated: the kernels' algorithm in torch (`Flash`), without and
  with the bf16 kernels' roundings (P rounded to bf16 for P.V, the row
  sums from the unrounded P; in the backward P from the logsumexp,
  rounded to bf16 for dV, and dS rounded to bf16 for dQ and dK);
- fp32: the plain versions with the whole superblock in fp32
  (compute_dtype float32, no TF32): the stand-in for the exact one.

Prints one JSON object an arch and seq: the superblock's output and each
gradient, ||a - b|| / ||b|| for each of PAIRS, and each pair's largest
reading; at gemma2-27b's longest seq, for each attention call the same
for its output (and the kernel's against the plain version's by blocks
of 1024 query rows) and for dq, dk and dv on the call's own inputs,
output and cotangent: the backward kernel's and the flash algorithm's
without and with the roundings, against the exact ones (the flash
algorithm in fp32 from the fp32 output); then the kernel against the
plain version with the softcap left out. Then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ROWS = 1024                 # the output's error by blocks of query rows
NUDGE = 1e-6                # the nudged way's relative move of the scale
WAYS = ("plain", "plain_again", "kernel", "nudged", "flash", "emulated",
        "fp32")
PAIRS = tuple((w, "plain") for w in WAYS if w not in ("plain", "fp32")) \
    + (("kernel", "emulated"),) \
    + tuple((w, "fp32") for w in WAYS if w != "fp32")
CALL_ARCH = "gemma2-27b"    # the arch whose calls are read one by one


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _bf16(x, rounded):
    return x.bfloat16().float() if rounded else x


def _head_slices(q, k):
    """(G, [(a, b)]): slices of whole GQA groups of about PLAIN_HEADS
    query rows of the kernels' layout."""
    G = q.shape[0] // k.shape[0]
    step = G * max(cs.PLAIN_HEADS // G, 1)
    return G, [(a, min(a + step, q.shape[0]))
               for a in range(0, q.shape[0], step)]


def _slice_scores(q, kf, causal, window, softcap, scale):
    """fp32 masked scores of a slice, the mask and the softcap's
    1 - tanh^2 (None without a cap)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), kf) * scale
    fac = None
    if softcap:
        t = torch.tanh(s / softcap)
        s, fac = softcap * t, 1.0 - t * t
    mask = cs.ref._mask(q.shape[1], kf.shape[1], causal, window, q.device)
    return s.masked_fill(~mask, -torch.inf), mask, fac


def flash_fwd(q, k, v, causal, window, softcap, scale, rounded):
    """The bf16 forward kernels' algorithm in the kernels' layout: P =
    exp(s - m), the row sums l from the unrounded P, out = (P V) / l with
    P rounded to bf16 where `rounded`. Returns (out, lse)."""
    G, slices = _head_slices(q, k)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    for a, b in slices:
        kf = k[a // G:b // G].float().repeat_interleave(G, 0)
        vf = v[a // G:b // G].float().repeat_interleave(G, 0)
        s, _, _ = _slice_scores(q[a:b], kf, causal, window, softcap, scale)
        m = s.amax(-1, keepdim=True).clamp_min(-1e30)
        p = torch.exp(s - m)
        lsum = p.sum(-1, keepdim=True)
        pv = torch.einsum("bqk,bkd->bqd", _bf16(p, rounded), vf)
        out[a:b] = (pv / lsum.clamp_min(1e-30)).to(q.dtype)
        lse[a:b] = (m + torch.log(lsum))[..., 0]
    return out, lse


def flash_bwd(q, k, v, out, g, lse, causal, window, softcap, scale,
              rounded):
    """The bf16 backward kernels' algorithm: P from the logsumexp, D =
    rowsum(g out) from `out` as given, dS = P (dP - D); P rounded to bf16
    for dV and dS for dQ and dK where `rounded`. Returns (dq, dk, dv)."""
    G, slices = _head_slices(q, k)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for a, b in slices:
        kf = k[a // G:b // G].float().repeat_interleave(G, 0)
        vf = v[a // G:b // G].float().repeat_interleave(G, 0)
        s, mask, fac = _slice_scores(q[a:b], kf, causal, window, softcap,
                                     scale)
        p = torch.where(mask, torch.exp(s - lse[a:b, :, None]), 0.0)
        gf = g[a:b].float()
        dvs = torch.einsum("bqk,bqd->bkd", _bf16(p, rounded), gf)
        delta = (gf * out[a:b].float()).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bqd,bkd->bqk", gf, vf) - delta)
        if fac is not None:
            ds = ds * fac
        ds = _bf16(ds, rounded)
        dq[a:b] = (torch.einsum("bqk,bkd->bqd", ds, kf) * scale).to(q.dtype)
        dks = torch.einsum("bqk,bqd->bkd", ds, q[a:b].float()) * scale
        n = (b - a) // G
        dk[a // G:b // G] += dks.view(n, G, *dks.shape[1:]).sum(1)
        dv[a // G:b // G] += dvs.view(n, G, *dvs.shape[1:]).sum(1)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class Flash(torch.autograd.Function):
    """`flash_fwd`, differentiated by `flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, rounded):
        out, lse = flash_fwd(q, k, v, causal, window, softcap, scale,
                             rounded)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = (causal, window, softcap, scale, rounded)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, out, g.to(q.dtype), lse, *ctx.kw),
                None, None, None, None, None)


def flash_mha(rounded):
    """`ops.mha_flash` through `Flash`, in the model's layout."""
    def mha(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
        B, Sq, H, hd = q.shape
        scale = hd ** -0.5 if scale is None else scale
        qf, kf, vf = (t.transpose(1, 2).reshape(-1, t.shape[1], hd)
                      for t in (q, k, v))
        out = Flash.apply(qf, kf, vf, causal, window, softcap, scale,
                          rounded)
        return out.reshape(B, H, Sq, hd).transpose(1, 2)
    return mha


def nudged_mha(q, k, v, *, scale=None, **kw):
    """`chip_smoke.plain_mha` with the scores' scale times 1 + NUDGE."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return PLAIN_MHA(q, k, v, scale=scale * (1 + NUDGE), **kw)


PLAIN_MHA = cs.plain_mha
MHA = {"nudged": nudged_mha, "flash": flash_mha(False),
       "emulated": flash_mha(True)}


@contextlib.contextmanager
def attention_as(fn):
    """`chip_smoke.Tap(plain=True)` runs attention through `fn` while
    open."""
    cs.plain_mha = fn
    try:
        yield
    finally:
        cs.plain_mha = PLAIN_MHA


def superblock(way, params, cfg, batch):
    """superblock0 one way: ((out, grads), the tap)."""
    tap = cs.Tap(plain=way != "kernel")
    if way == "fp32":
        cfg = cs.dataclasses.replace(cfg, compute_dtype="float32")
    with attention_as(MHA.get(way, PLAIN_MHA)):
        return cs.superblock0(params, cfg, batch, tap), tap


def superblock_rows(params, cfg, batch):
    """Each of PAIRS over the output and every gradient, computed way by
    way (three runs kept at a time), and the kernels' tapped calls."""
    keep = {}
    rows = {}

    def add(a, b):
        (out_a, g_a), (out_b, g_b) = keep[a], keep[b]
        rows.setdefault("out", {})[f"{a}_vs_{b}"] = rel(out_a, out_b)
        for path in g_b:
            rows.setdefault(f"grad/{path}", {})[f"{a}_vs_{b}"] = rel(
                g_a[path], g_b[path])

    calls = []
    for way in ("plain", "fp32", "kernel", "plain_again", "nudged", "flash",
                "emulated"):
        keep[way], tap = superblock(way, params, cfg, batch)
        if way == "kernel":
            calls = tap.calls
        for a, b in PAIRS:
            if way in (a, b) and a in keep and b in keep:
                add(a, b)
        if way not in ("plain", "fp32", "kernel"):
            del keep[way]
        torch.cuda.empty_cache()
    largest = {f"{a}_vs_{b}": max(r[f"{a}_vs_{b}"] for r in rows.values())
               for a, b in PAIRS}
    return rows, largest, calls


def kernel_grads(qf, kf, vf, g, kw):
    """dq, dk, dv through `flash_attention`'s autograd Function: the
    forward kernel again, then the backward kernels from its
    logsumexp."""
    leaves = [t.detach().requires_grad_(True) for t in (qf, kf, vf)]
    with torch.enable_grad():
        out = cs.fa.flash_attention(*leaves, **kw)
        return torch.autograd.grad(out, leaves, g)


def call_rows(rec):
    """One tapped attention call: its output and gradients each way; the
    exact gradients are the flash algorithm's in fp32 from the fp32
    output (autograd's)."""
    qf, kf, vf, of = cs.flat_attention(rec)
    kw = dict(rec["kw"])
    args = (kw["causal"], kw["window"], kw["softcap"], kw["scale"])
    g = cs.flat_heads(rec["g_out"]).contiguous()
    plain = cs.attention_plain(qf, kf, vf, **kw)
    nudged = cs.attention_plain(qf, kf, vf,
                                **{**kw, "scale": kw["scale"] * (1 + NUDGE)})
    flash, flash_lse = flash_fwd(qf, kf, vf, *args, False)
    emul, emul_lse = flash_fwd(qf, kf, vf, *args, True)
    row = {"call": cs.call_name(rec),
           "out": {"kernel_vs_plain": rel(of, plain),
                   "nudged_vs_plain": rel(nudged, plain),
                   "flash_vs_plain": rel(flash, plain),
                   "emulated_vs_plain": rel(emul, plain),
                   "kernel_vs_emulated": rel(of, emul)},
           "out_kernel_vs_plain_by_rows": [
               rel(of[:, a:a + ROWS], plain[:, a:a + ROWS])
               for a in range(0, qf.shape[1], ROWS)]}
    del nudged, flash
    grads = {"kernel": kernel_grads(qf, kf, vf, g, kw),
             "flash": flash_bwd(qf, kf, vf, of, g, flash_lse, *args, False),
             "emulated": flash_bwd(qf, kf, vf, of, g, emul_lse, *args,
                                   True)}
    f32 = [t.float() for t in (qf, kf, vf)]
    out32, lse32 = flash_fwd(*f32, *args, False)
    grads["exact"] = flash_bwd(*f32, out32, g.float(), lse32, *args, False)
    del out32
    for i, name in enumerate(("dq", "dk", "dv")):
        row[name] = {f"{a}_vs_{b}": rel(grads[a][i], grads[b][i])
                     for a, b in (("kernel", "exact"), ("flash", "exact"),
                                  ("emulated", "exact"),
                                  ("kernel", "emulated"))}
    if kw["softcap"]:
        nocap = {**kw, "softcap": 0.0}
        out = cs.fa.flash_attention(qf, kf, vf, **nocap)
        row["no_softcap_out_kernel_vs_plain"] = rel(
            out, cs.attention_plain(qf, kf, vf, **nocap))
    return row


def main():
    cells = {c[0]: c for c in cs.TRAIN_LM_CELLS}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=[CALL_ARCH],
                    choices=sorted(cells))
    ap.add_argument("--seqs", type=int, nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_long_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 as the reference
    cs.phase_build()
    for arch in args.arch:
        _, layers, B, S, _ = cells[arch]
        cfg = cs.registry.get_config(arch)
        if layers is not None:
            cfg = cs.dataclasses.replace(cfg, n_layers=layers)
        seqs = sorted(min(s, S) for s in args.seqs or [S])
        params, pipe = cs.cell_state(cfg, B, max(seqs))
        batch = cs.seeded_batch(pipe.batch_at(0), cfg, "cuda")
        for seq in seqs:
            sub = dict(batch, tokens=batch["tokens"][:, :seq])
            rows, largest, calls = superblock_rows(params, cfg, sub)
            row = {"arch": arch, "batch": B, "seq": seq, "nudge": NUDGE,
                   "largest": largest, "superblock": rows}
            if arch == CALL_ARCH and seq == seqs[-1]:
                with torch.no_grad():
                    row["calls"] = [call_rows(rec) for rec in calls
                                    if len(rec["args"]) == 3]
            del calls
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
        del params, pipe, batch
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
