"""End-to-end LM training driver, as the reference's
`repro/launch/train.py`.

Composes the substrate: config registry -> params + AdamW -> the
deterministic data pipeline (prefetching) -> a train step (`make_train_step`)
-> step-atomic asynchronous checkpoints -> straggler telemetry. One
device and no mesh: the reference's production mesh and sharding rules
come with the port's XLA tooling. It runs on CUDA unless given
`device="cpu"` (`--device cpu`), and raises without a CUDA device
otherwise; on the card every attention layer goes through the
flash-attention kernel and every Mamba layer through the scan kernel,
forward and remat recompute (`kernels.ops`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--device cpu]

The initial weights are the reference's: `lm.init_params(prng_key(seed))`
draws `jax.random`'s numbers on the device (through the threefry kernel
on the card), and the data pipeline is the reference's, so a seed starts
the reference's run.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.core.agent import resolve_device
from repro_torch.data import SyntheticLMPipeline
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.compress import compress_grads
from repro_torch.runtime import StragglerMonitor
from repro_torch.tree import tree_map


def make_train_step(cfg, opt_cfg, total_steps, grad_compress=False):
    def train_step(params, opt_state, err_state, batch):
        (loss, metrics), grads = loss_and_grads(params, batch, cfg)
        if grad_compress:
            grads, err_state = compress_grads(grads, err_state)
        lr_scale = cosine_schedule(opt_state["step"],
                                   warmup=max(total_steps // 50, 1),
                                   total=total_steps)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg, lr_scale)
        return params, opt_state, err_state, {"loss": loss, **metrics, **om}
    return train_step


def batch_on(batch_np, cfg, device):
    """A pipeline batch on `device`, with the zero `memory` (vlm) or
    `frames` (enc-dec) the driver feeds those families."""
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in batch_np.items()}
    B = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["memory"] = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                                      dtype=cfg.cdtype, device=device)
    if cfg.encoder is not None:
        batch["frames"] = torch.zeros((B, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=torch.float32, device=device)
    return batch


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          global_batch: int = 8, seq_len: int = 256,
          ckpt_dir=None, ckpt_every: int = 50, restore: bool = False,
          grad_compress: bool = False, lr: float = 3e-4,
          log_every: int = 10, seed: int = 0, device=None):
    """Train `arch` (its reduced config if `smoke`) for `steps` steps.
    Returns (params, the losses of the steps this call ran)."""
    cfg = registry.get_config(arch)
    if smoke:
        cfg = registry.reduced(cfg)
    dev = resolve_device(device, "train")
    opt_cfg = AdamWConfig(lr=lr)

    params = lm.init_params(prng.prng_key(seed), cfg, device=dev)
    opt_state = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    err_state = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
        params) if grad_compress else 0

    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=global_batch, seed=seed,
                               n_logical_shards=global_batch)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and restore:
        try:
            state, start_step, extra = ckpt.restore([params, opt_state])
            params, opt_state = (tree_map(lambda t: t.to(dev), state[k])
                                 for k in ("0", "1"))
            pipe.state.step = int(extra.get("data_step", start_step))
            print(f"restored checkpoint at step {start_step}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")
    pipe.state.step = max(pipe.state.step, start_step)
    pipe.start_prefetch()

    step_fn = make_train_step(cfg, opt_cfg, steps, grad_compress)
    monitor = StragglerMonitor()
    losses = []
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            batch = batch_on(next(pipe), cfg, dev)
            t0 = time.time()
            params, opt_state, err_state, metrics = step_fn(
                params, opt_state, err_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.report(0, time.time() - t0)
            if log_every and (step + 1) % log_every == 0:
                tok_s = global_batch * seq_len * log_every / max(
                    time.time() - t_start, 1e-9)
                t_start = time.time()
                print(f"step {step+1:5d} loss {loss:7.4f} "
                      f"gnorm {float(metrics['grad_norm']):6.2f} "
                      f"tok/s {tok_s:9.0f}")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, [params, opt_state],
                          extra={"data_step": pipe.state.step},
                          blocking=False)
        if ckpt:
            ckpt.save(steps, [params, opt_state],
                      extra={"data_step": pipe.state.step}, blocking=True)
    finally:
        pipe.stop_prefetch()
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path; CUDA by default")
    args = ap.parse_args()
    _, losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                      global_batch=args.batch, seq_len=args.seq,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      restore=args.restore, grad_compress=args.grad_compress,
                      lr=args.lr, device=args.device)
    print(f"final loss: {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
