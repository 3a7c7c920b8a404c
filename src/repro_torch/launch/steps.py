"""Step functions, as the reference's `repro/launch/steps.py`:

  * train_step  — fwd + bwd + AdamW
  * prefill     — prompt -> logits + cache
  * serve_step  — one decode token against the cache

A train step takes the gradients of `lm.loss_fn` with
`torch.autograd.grad` over every parameter leaf and updates the
parameters and the AdamW state in place (where the reference donates its
buffers). The parameter tensors are marked as needing a gradient for the
step and left as they were after it.

The input specs (`batch_struct`, `params_struct`, `opt_struct`,
`cache_struct`, `input_specs`), the reference's `ShapeDtypeStruct`
stand-ins, are tensors on the `meta` device: shapes and dtypes with no
data, which the step functions run on as they run on the card
(`launch.dryrun`). A decode cell's cache is full: its write heads stand
at seq_len - 1, where the step writes its token.
"""
from __future__ import annotations

import torch

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.sharding import act as act_sharding
from repro_torch.tree import flatten, tree_map, unflatten


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
                    total_steps: int = 10_000, grad_compress: bool = False,
                    mesh=None):
    """The reference's train step, (params, opt_state, batch) -> (params,
    opt_state, metrics): `error_fed_step` with a fresh error state each
    step and a warmup of total_steps // 50."""
    step = error_fed_step(cfg, opt_cfg, total_steps, total_steps // 50,
                          grad_compress, mesh)

    def train_step(params, opt_state, batch):
        params, opt_state, _, metrics = step(params, opt_state, None, batch)
        return params, opt_state, metrics
    return train_step


def error_fed_step(cfg: ModelConfig, opt_cfg: AdamWConfig, total_steps: int,
                   warmup: int, grad_compress: bool = False, mesh=None):
    """A train step that threads gradient compression's error state,
    (params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics); err_state None starts from zeros. `mesh`: one
    rank's step across a joined mesh (module docstring)."""
    def train_step(params, opt_state, err_state, batch):
        with act_sharding.across(mesh):
            (loss, metrics), grads = loss_and_grads(params, batch, cfg)
        if grad_compress:
            from repro_torch.optim.compress import compress_grads
            grads, err_state = compress_grads(grads, err_state, mesh=mesh)
        lr_scale = cosine_schedule(opt_state["step"], warmup=warmup,
                                   total=total_steps)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg, lr_scale, mesh=mesh)
        return params, opt_state, err_state, {"loss": loss, **metrics, **om}
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


# ------------------------------------------------------------------ specs
META = "meta"


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 device=META) -> Dict[str, Any]:
    """Stand-ins for the data inputs of one cell. A decode step's "pos" is
    a host int32 scalar, as the cache's write heads are."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                       device=device)}
        if cfg.family == "vlm":
            batch["memory"] = torch.zeros(
                (B, cfg.vision_tokens, cfg.d_model), dtype=cfg.cdtype,
                device=device)
        if cfg.encoder is not None:
            batch["frames"] = torch.zeros(
                (B, cfg.encoder.n_frames, cfg.d_model), dtype=torch.float32,
                device=device)
        return batch
    # decode: one new token against a seq_len cache
    return {"token": torch.zeros((B, 1), dtype=torch.int32, device=device),
            "pos": torch.tensor(S - 1, dtype=torch.int32)}


def params_struct(cfg: ModelConfig, device=META):
    """The parameters of `jax.random.PRNGKey(0)`; on `meta`, no data."""
    return lm.init_params(prng.prng_key(0), cfg, device=device)


def opt_struct(cfg: ModelConfig, device=META):
    """AdamW's zero state, shaped by a build on `meta` (nothing drawn)."""
    state = adamw_init(params_struct(cfg),
                       getattr(torch, cfg.opt_moment_dtype))
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), state)


def cache_struct(cfg: ModelConfig, shape: ShapeConfig, device=META):
    """A full decode cache: every write head at seq_len - 1."""
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=device)
    for entry in cache.values():
        if "pos" in entry:
            entry["pos"].fill_(shape.seq_len - 1)
    return cache


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device=META) -> Tuple:
    """The positional inputs of the cell's step function:

    train:   (params, opt_state, batch)
    prefill: (params, batch)
    decode:  (params, cache, batch)
    """
    if shape.kind == "train":
        return (params_struct(cfg, device), opt_struct(cfg, device),
                batch_struct(cfg, shape, device))
    if shape.kind == "prefill":
        return (params_struct(cfg, device), batch_struct(cfg, shape, device))
    return (params_struct(cfg, device), cache_struct(cfg, shape, device),
            batch_struct(cfg, shape, device))


def step_fn(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return make_train_step(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, max_len=shape.seq_len)
    return make_serve_step(cfg)
