"""AdamW written by hand over parameter trees, as the reference's
`repro/optim/adamw.py` computes it (not `torch.optim.AdamW`, whose order
of operations differs).

A tree is a nested dict of tensors (`repro_torch.tree`); the moments
mirror it in fp32 and `step` is an int32 scalar tensor. One update:
global-norm clip with scale = min(1, clip / (gnorm + 1e-9)), bias
correction on m and v, decoupled weight decay added into the step u
before the learning rate multiplies it.

The reference computes this in jnp outside any kernel, and so does the
port: plain elementwise tensor ops on the parameters' device, one
`torch._foreach_*` call a step for all leaves. Where the
reference donates its buffers to XLA, `adamw_update` writes the new
parameters and moments IN PLACE under `torch.no_grad()` and returns the
same trees; the parameter tensors (`nn.Parameter`s) keep their identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of sum(x^2), fp32."""
    sq = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (params, state, {"grad_norm", "lr"}); params, m and v are
    updated in place, `state["step"]` is a new tensor. Each elementwise
    step is one `torch._foreach_*` call over all leaves, the reference's
    operations in its order."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    bc1 = 1 - (one * cfg.b1) ** stepf
    bc2 = 1 - (one * cfg.b2) ** stepf
    lr = cfg.lr * lr_scale
    p, m, v = leaves(params), leaves(state["m"]), leaves(state["v"])
    g = torch._foreach_mul([x.float() for x in leaves(grads)], scale)
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - cfg.b2))
    den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(den, cfg.eps)
    u = torch._foreach_div(torch._foreach_div(m, bc1), den)
    if cfg.weight_decay:
        torch._foreach_add_(u, torch._foreach_mul(p, cfg.weight_decay))
    torch._foreach_sub_(p, torch._foreach_mul(u, lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
