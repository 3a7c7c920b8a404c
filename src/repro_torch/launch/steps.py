"""Step functions, as the reference's `repro/launch/steps.py`:

  * train_step  — fwd + bwd + AdamW
  * prefill     — prompt -> logits + cache
  * serve_step  — one decode token against the cache

A train step takes the gradients of `lm.loss_fn` with
`torch.autograd.grad` over every parameter leaf and updates the
parameters and the AdamW state in place (where the reference donates its
buffers). The parameter tensors are marked as needing a gradient for the
step and left as they were after it. The reference's `ShapeDtypeStruct`
input specs feed its dry run and come with the port's XLA tooling.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, adamw_update,
                               cosine_schedule)
from repro_torch.tree import flatten, unflatten


def loss_and_grads(params, batch, cfg):
    """((loss, metrics), grads) of `lm.loss_fn` at `params`: the
    counterpart of `jax.value_and_grad(lm.loss_fn, has_aux=True)`. A leaf
    the loss does not reach gets a zero gradient, as in jax."""
    named = flatten(params)
    flags = [t.requires_grad for _, t in named]
    for _, t in named:
        t.requires_grad_(True)
    try:
        loss, metrics = lm.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
    finally:
        for (_, t), flag in zip(named, flags):
            t.requires_grad_(flag)
    grads = {name: torch.zeros_like(t) if g is None else g
             for (name, t), g in zip(named, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    total_steps: int = 10_000, grad_compress: bool = False):
    def train_step(params, opt_state, batch):
        (loss, metrics), grads = loss_and_grads(params, batch, cfg)
        if grad_compress:
            from repro_torch.optim.compress import compress_grads
            grads, _ = compress_grads(grads)
        lr_scale = cosine_schedule(opt_state["step"],
                                   warmup=total_steps // 50, total=total_steps)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg, lr_scale)
        return params, opt_state, {"loss": loss, **metrics, **om}
    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        memory = batch.get("memory")
        if cfg.encoder is not None:
            memory = lm.encode(params, batch["frames"], cfg)
        return lm.prefill(params, batch["tokens"], cfg, max_len, memory=memory)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        return lm.decode_step(params, batch["token"], cache, cfg, batch["pos"])
    return serve_step
