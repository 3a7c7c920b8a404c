"""End-to-end LM training driver, as the reference's
`repro/launch/train.py`.

Composes the substrate: config registry -> params + AdamW -> the
deterministic data pipeline (prefetching) -> a train step (`make_train_step`)
-> step-atomic asynchronous checkpoints -> straggler telemetry. It runs on
one device, or across the ranks of a joined mesh (`mesh`, `--tp N`): one
rank a card, the reference's train step under its `shard_map` policy on a
(1, N) mesh (`launch.steps`), each rank drawing, training and keeping the
AdamW state of only its E/N experts of every MoE layer and a whole copy
of every other leaf, all ranks fed the same batch. It runs on CUDA
unless given `device="cpu"` (`--device cpu`), and raises without a CUDA device
otherwise; on the card every attention layer goes through the
flash-attention kernel and every Mamba layer through the scan kernel,
forward and remat recompute (`kernels.ops`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \\
      --smoke --tp 4 --ckpt-dir /tmp/ckpt [--restore] [--device cpu]

`--tp N` spawns N ranks (`launch.mesh.spawn_ranks`): NCCL over N cards,
or with `--device cpu` N gloo ranks on the CPU, each with cores / N torch
threads; rank 0 logs.

Checkpoints (`--ckpt-dir D`, every `--ckpt-every` steps, asynchronously,
and at the end) hold `(params, opt_state)` and the pipeline's
`data_step` in the reference's layout (`checkpoint.Checkpointer`), with
or without a mesh: across ranks each rank writes its experts' runs of
every expert leaf into the one file of that leaf, so the directory is the
one a run without a mesh writes, and it restores (`--restore`) on any
number of ranks that divides the experts, in the reference too. A
restored run continues the run that wrote the checkpoint bit for bit.
The reference checkpoints no error state of `--grad-compress`: a run
restored with compression starts its error feedback at zero, in both
packages.

The initial weights are the reference's: `lm.init_params(prng_key(seed))`
draws `jax.random`'s numbers on the device (through the threefry kernel
on the card), and the data pipeline is the reference's, so a seed starts
the reference's run.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.core.agent import resolve_device
from repro_torch.data import SyntheticLMPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import error_fed_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import StragglerMonitor
from repro_torch.sharding import act as act_sharding
from repro_torch.tree import tree_map


def make_train_step(cfg, opt_cfg, total_steps, grad_compress=False,
                    mesh=None):
    """The driver's step, (params, opt_state, err_state, batch) -> (params,
    opt_state, err_state, metrics): `launch.steps.error_fed_step` with a
    warmup of at least one step."""
    return error_fed_step(cfg, opt_cfg, total_steps,
                          max(total_steps // 50, 1), grad_compress, mesh)


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
          log_every: int = 10, seed: int = 0, device=None, mesh=None):
    """Train `arch` (its reduced config if `smoke`) for `steps` steps.
    `mesh`: a joined mesh (`launch.mesh.join_host_mesh`), this process one
    of its ranks, on the mesh's device unless `device` is given; it holds
    its E/tp experts of each MoE layer (drawn from the seed at their
    offsets), writes and restores its part of each checkpoint in
    `ckpt_dir`, and logs only on rank 0. Returns (params, the losses of
    the steps this call ran)."""
    cfg = registry.get_config(arch)
    if smoke:
        cfg = registry.reduced(cfg)
    if mesh is not None:
        if not act_sharding.joined(mesh):
            raise ValueError("train takes a joined mesh "
                             "(launch.mesh.join_host_mesh)")
        log_every = log_every if mesh.rank == 0 else 0
    dev = resolve_device(device or (mesh.device if mesh is not None
                                    else None), "train")
    opt_cfg = AdamWConfig(lr=lr)

    params = lm.init_params(prng.prng_key(seed), cfg, device=dev, mesh=mesh)
    opt_state = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    err_state = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
        params) if grad_compress else 0

    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=global_batch, seed=seed,
                               n_logical_shards=global_batch)
    ckpt = Checkpointer(ckpt_dir, mesh=mesh) if ckpt_dir else None
    start_step = 0
    lead = mesh is None or mesh.rank == 0
    if ckpt and restore:
        try:
            _, start_step, extra = ckpt.restore([params, opt_state],
                                                into=True)
            pipe.state.step = int(extra.get("data_step", start_step))
            if lead:
                print(f"restored checkpoint at step {start_step}")
        except FileNotFoundError:
            if lead:
                print("no checkpoint found; starting fresh")
    pipe.state.step = max(pipe.state.step, start_step)
    pipe.start_prefetch()

    step_fn = make_train_step(cfg, opt_cfg, steps, grad_compress, mesh)
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
            monitor.report(mesh.rank if mesh is not None else 0,
                           time.time() - t0)
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


def _train_rank(mesh, arch, kw):
    """One rank of `main --tp N`: its losses."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    return train(arch, mesh=mesh, **kw)[1]


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
    ap.add_argument("--tp", type=int, default=0,
                    help="train across N ranks, one card each (NCCL; with "
                         "--device cpu, N gloo ranks on the CPU), the "
                         "experts split N ways")
    args = ap.parse_args()
    kw = dict(smoke=args.smoke, steps=args.steps, global_batch=args.batch,
              seq_len=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, restore=args.restore,
              grad_compress=args.grad_compress, lr=args.lr)
    if args.tp:
        cpu = args.device == "cpu"
        if not cpu and torch.cuda.device_count() < args.tp:
            raise SystemExit(f"--tp {args.tp} takes {args.tp} cards; "
                             f"{torch.cuda.device_count()} found")
        ranked = mesh_lib.spawn_ranks(
            _train_rank, args.tp, (args.arch, kw),
            backend="gloo" if cpu else "nccl",
            devices=["cpu"] * args.tp if cpu else None)
        if any(r != ranked[0] for r in ranked):
            raise SystemExit(f"the ranks' losses differ: {ranked}")
        losses = ranked[0]
        print(f"{args.tp} ranks, equal losses: "
              f"{' '.join(f'{x:.6f}' for x in losses)}")
    else:
        _, losses = train(args.arch, device=args.device, **kw)
        print(f"losses: {' '.join(f'{x:.6f}' for x in losses)}")
    print(f"final loss: {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
