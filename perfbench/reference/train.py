"""The plain reference's training steps: the loss of `reference.lm`, its
gradients by autograd, the global norm, clipping, AdamW with bias
correction and decoupled weight decay, and the learning rate's linear
warmup and cosine decay, all in float32 (TF32 off).

`follow` runs the first steps of a cell from the parameters the benchmark
drew and the batches its traffic gives, and returns what a check compares
against the program: each step's loss, the first step's global gradient
norm, each parameter slice's first gradient norm after clipping (as the
optimizer takes it) and each slice's change over the steps. A slice is
one layer of a stacked leaf, or a whole unstacked leaf.

Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import lm


def lr_scale(step: int, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup from 0 over `warmup` steps, then a cosine from 1 to
    `floor` at `total`; `step` counts the updates made before this one."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def slices(path, t):
    """(name, view) of each slice of a leaf: its layers when stacked."""
    if path.startswith("stack/"):
        return [(f"{path}#{i}", t[i]) for i in range(t.shape[0])]
    return [(path, t)]


def slice_norms(named, ranks=None, split=()):
    """{slice name: float norm} of {path: tensor}. Across processes
    (`ranks`), the squares of a leaf in `split`, of which each process
    holds a part, are summed over them."""
    sq = {}
    for path, t in named.items():
        for name, s in slices(path, t):
            sq[name] = (s.float().square().sum(), path in split)
    return _roots(sq, ranks)


def _roots(sq, ranks):
    """{name: sqrt(sum of squares)} of {name: (square sum, split)}."""
    parts = [k for k, (_, part) in sq.items() if part]
    if ranks is not None and parts:
        import torch.distributed as dist
        both = torch.stack([sq[k][0] for k in parts])
        dist.all_reduce(both, group=ranks[0])
        sq.update({k: (v, True) for k, v in zip(parts, both.unbind())})
    return {k: math.sqrt(float(v)) for k, (v, _) in sq.items()}


def follow(cfg, opt, make_leaf, paths, batches, *, prec="fp32",
           ranks=None, split=(), half_batch=False, exchange=True):
    """The reference's first len(batches) steps.

    make_leaf(path) -> the leaf as the benchmark drew it (float32, on the
    device the reference runs on); paths: every leaf's path; batches:
    [(tokens, mask)], one a step; opt: {"lr", "b1", "b2", "eps",
    "weight_decay", "grad_clip", "total_steps"}, warming up over
    total_steps // 50 steps (at least 1), as the train step under test
    does; ranks: None or
    (process group, first expert held) across processes, where `split`
    names the expert leaves whose squares are summed over the processes
    for the global norm. half_batch: a fault, the loss over the first half
    of each batch's rows only (of a batch of one row, of its tokens);
    exchange=False: a fault, the sum of the processes' experts left out.

    Returns {"losses", "grad_norm", "grad_slices", "change_slices"}."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()     # what an earlier follow left cached
    warmup = max(opt["total_steps"] // 50, 1)
    with lm.strict_float32():
        params = {p: make_leaf(p).float().requires_grad_(True)
                  for p in paths}
        m = {p: torch.zeros_like(t) for p, t in params.items()}
        v = {p: torch.zeros_like(t) for p, t in params.items()}
        out = {"losses": []}
        for step, (tokens, mask) in enumerate(batches):
            if half_batch:
                tokens, mask = _half(tokens), _half(mask)
            loss = lm.loss(params, tokens, mask, cfg, prec, ranks, exchange)
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            out["losses"].append(float(loss.detach()))
            del loss
            # no leaf-sized temporary: falcon's 8 GiB leaves
            sq = {p: torch.linalg.vector_norm(g).square()
                  for p, g in grads.items()}
            if ranks is not None and split:
                import torch.distributed as dist
                part = torch.stack([sq[p] for p in split])
                dist.all_reduce(part, group=ranks[0])
                sq.update(zip(split, part.unbind()))
            gnorm = torch.sqrt(sum(sq.values()))
            scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            t = step + 1
            bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
            lr = opt["lr"] * lr_scale(step, warmup, opt["total_steps"])
            first = {}
            with torch.no_grad():
                for p, w in params.items():
                    # a layer at a time, so that the temporaries stay small
                    for (name, ws), (_, gs), (_, ms), (_, vs) in zip(
                            *(slices(p, t) for t in (w, grads[p], m[p],
                                                     v[p]))):
                        g = gs * scale
                        if step == 0:         # as the optimizer takes it
                            first[name] = (g.square().sum(), p in split)
                        ms.mul_(opt["b1"]).add_(g * (1 - opt["b1"]))
                        vs.mul_(opt["b2"]).add_(g * g * (1 - opt["b2"]))
                        u = (ms / bc1) / (torch.sqrt(vs / bc2) + opt["eps"])
                        u = u + ws * opt["weight_decay"]
                        ws.sub_(u * lr)
            if step == 0:
                out["grad_norm"] = float(gnorm)
                out["grad_slices"] = _roots(first, ranks)
            del grads
        del m, v
        out["change_slices"] = change_norms(params, make_leaf, ranks, split)
        return out


def _half(t):
    return t[:t.shape[0] // 2] if t.shape[0] > 1 else t[:, :t.shape[1] // 2]


@torch.no_grad()
def change_norms(params, make_leaf, ranks=None, split=()):
    """Each slice's norm of its change from the leaf as drawn, a leaf at a
    time."""
    sq = {}
    for p, w in params.items():
        d = make_leaf(p).float()
        d.sub_(w.float())           # in place: one leaf-sized temporary
        for name, s in slices(p, d):
            sq[name] = (s.square().sum(), p in split)
        del d
    return _roots(sq, ranks)
