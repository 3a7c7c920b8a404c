"""AdamW written by hand over parameter trees, as the reference's
`repro/optim/adamw.py` computes it (not `torch.optim.AdamW`, whose order
of operations differs).

A tree is a nested dict of tensors (`repro_torch.tree`); the moments
mirror it in `moment_dtype` (fp32 unless asked: jamba-1.5-large keeps
bf16 moments) and `step` is an int32 scalar tensor. One update:
global-norm clip with scale = min(1, clip / (gnorm + 1e-9)), bias
correction on m and v, decoupled weight decay added into the step u
before the learning rate multiplies it. m, v and the parameters are
computed in fp32 and rounded to their own dtypes after the step.

The reference computes this in jnp outside any kernel, and so does the
port: plain elementwise tensor ops on the parameters' device, the
reference's operations in its order, each one `torch._foreach_*` call
over a group of leaves. Where the reference donates its buffers to XLA,
`adamw_update` writes the new parameters and moments IN PLACE under
`torch.no_grad()` and returns the same trees; the parameter tensors keep
their identity. The temporaries are bounded: a group holds at most CHUNK
elements, a leaf larger than that cut in slices along its first axis (a
stacked superblock leaf one or more superblocks at a time), so that a
step needs a few hundred MB beyond the parameters, gradients and moments
whatever the model's size; a small model's leaves make one group. On
the CPU a group holds at most CPU_CHUNK elements, whose operands and
temporaries the caches and the allocator keep: there each operation's
pass over a 2^25-element group ran from memory into a fresh mapping.
Each element's arithmetic does not depend on the grouping.

Across ranks (`mesh`, joined: `launch.mesh.join_host_mesh`, one rank a
card) a rank holds E/tp experts of each expert leaf
(`sharding.act.split_leaves`) and every other leaf whole, with that
leaf's whole gradient (`sharding.act`). The global norm is the one norm
of all the model's gradients: the ranks' sums of squares of the expert
leaves are summed by one all_reduce, and every rank adds each leaf's
sum in the sorted-leaf order, each counted once. So every rank clips by
the same scale as one device, and its leaves held whole take the same
update on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.sharding import act as act_sharding
from repro_torch.tree import flatten, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


CHUNK = 1 << 25         # elements of a leaf updated at once (128 MB in fp32)
CPU_CHUNK = 1 << 20     # at most that many on the CPU (4 MB in fp32)


def adamw_init(params, moment_dtype=torch.float32) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    step_device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of sum(x^2), fp32.
    On a joined `mesh` an expert leaf's sum is the ranks' sums summed (one
    all_reduce for all of them)."""
    sums = {path: torch.sum(torch.square(x.float()))
            for path, x in flatten(tree)}
    split = act_sharding.split_leaves(tree, mesh)
    if split:
        whole = act_sharding.reduce_stats(
            torch.stack([sums[p] for p in split]), mesh)
        sums.update(zip(split, whole.unbind()))
    sq = None
    for s in sums.values():
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _chunk(device) -> int:
    """The elements a group holds on `device` (module docstring)."""
    return min(CHUNK, CPU_CHUNK) if device.type == "cpu" else CHUNK


def _slices(t, chunk):
    """Views of `t` along its first axis, each of at most `chunk` elements
    (at least one row); a scalar as one view of one element."""
    t = t.reshape(1) if t.dim() == 0 else t
    rows = max(1, chunk // max(1, t[0].numel())) if len(t) else 1
    return [t[a:a + rows] for a in range(0, len(t), rows)]


def _groups(*trees):
    """The leaves of the trees (params, grads, m, v), cut by `_slices`,
    gathered into groups of consecutive slices of at most `_chunk`
    elements in all (a larger slice alone): lists of (p, g, m, v) views."""
    group, size = [], 0
    for leaf in zip(*map(leaves, trees)):
        chunk = _chunk(leaf[0].device)
        for piece in zip(*(_slices(t, chunk) for t in leaf)):
            n = piece[0].numel()
            if group and size + n > chunk:
                yield group
                group, size = [], 0
            group.append(piece)
            size += n
    if group:
        yield group


def _update(group, scale, bc1, bc2, lr, cfg: AdamWConfig):
    """One group's step, in place: one `torch._foreach_*` call an
    operation; m, v and p in fp32, then rounded to their own dtypes."""
    p, g, m, v = (list(t) for t in zip(*group))
    g = torch._foreach_mul([x.float() for x in g], scale)
    m32, v32 = [x.float() for x in m], [x.float() for x in v]
    torch._foreach_mul_(m32, cfg.b1)
    torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v32, cfg.b2)
    torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g, g),
                                                1 - cfg.b2))
    den = torch._foreach_sqrt(torch._foreach_div(v32, bc2))
    torch._foreach_add_(den, cfg.eps)
    u = torch._foreach_div(torch._foreach_div(m32, bc1), den)
    if cfg.weight_decay:
        torch._foreach_add_(u, torch._foreach_mul([x.float() for x in p],
                                                  cfg.weight_decay))
    p32 = [x.float() for x in p]                 # p itself in fp32
    torch._foreach_sub_(p32, torch._foreach_mul(u, lr))
    for t, t32 in zip(m + v + p, m32 + v32 + p32):
        if t32 is not t:
            t.copy_(t32)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0,
                 mesh=None):
    """Returns (params, state, {"grad_norm", "lr"}); params, m and v are
    updated in place, `state["step"]` is a new tensor. The update runs
    group after group of leaves (`_groups`). `mesh`: a joined mesh whose
    rank holds its slice of the expert leaves (`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, mesh)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    bc1 = 1 - (one * cfg.b1) ** stepf
    bc2 = 1 - (one * cfg.b2) ** stepf
    lr = cfg.lr * lr_scale
    for group in _groups(params, grads, state["m"], state["v"]):
        _update(group, scale, bc1, bc2, lr, cfg)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
