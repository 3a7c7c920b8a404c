"""Batched LM server: prefill a static batch of prompts into KV/SSM
caches from `lm.init_cache`, then decode in lockstep (the reference's
`repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --smoke --requests 8 --prompt-len 64 --gen 32 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --tp 4

It runs on CUDA unless given `device="cpu"` (`--device cpu`), and raises
without a CUDA device otherwise. Attention goes through the
flash-attention kernel and a Mamba prefill through the scan kernel
(`kernels.ops`); everything else is eager torch (no `torch.compile`, no
CUDA graph). The server decodes from its serving copy of the weights
(`lm.serving_params`): cast once from given parameters, or, from a seed,
drawn as that copy (`lm.init_params(..., serving=True)`), so that the
parameters in `param_dtype` are never held on the device.

Across cards (`mesh`, a `launch.mesh.join_host_mesh` of one rank a card,
`--tp N`): each rank holds its E/tp experts of every MoE layer and a
whole copy of every other leaf, and runs the same `generate` under
`ActivationPolicy(moe_dispatch="shard_map", mesh=mesh)`, the reference's
`shard_map` dispatch, its psum an all_reduce a MoE layer
(`models/moe.py`). The ranks decode in lockstep; after the prefill and
every step an all_gather checks that every rank chose the same tokens,
and a mismatch raises.

A seed gives the reference's server: its weights are
`lm.init_params(prng_key(seed))`, the reference's bit for bit, and a
sampled decode draws the reference's Gumbel noise from the same chain of
`jax.random` keys (`kernels.threefry`: the kernel on the card, its plain
version on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.core.agent import resolve_device
from repro_torch.kernels import threefry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm, moe
from repro_torch.sharding import act as act_sharding
from repro_torch.tree import flatten, leaves, tree_map


class BatchedServer:
    """Static-batch decode server (the dry-run's serve_step semantics):
    admits up to `max_batch` requests, prefills them together, then decodes
    lockstep.

    `params`: the parameters (`lm.init_params`'s tree, e.g. a reference's
    carried across by `checkpoint.lm_params_from_numpy`), moved to the
    device and cast; without them, the serving copy of
    `lm.init_params(prng_key(seed))`, the reference server's weights,
    drawn as such on the device. The server keeps only the serving copy
    (`serving`).

    `mesh`: a joined mesh (`launch.mesh.join_host_mesh`), this process
    one of its ranks, on the mesh's device unless `device` is given; the
    seeded build draws only the rank's experts, and given `params` must
    hold only them (`checkpoint.lm_params_from_numpy(..., mesh=)`)."""

    def __init__(self, cfg, *, max_batch: int = 8, max_len: int = 512,
                 seed: int = 0, params=None, device=None, mesh=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.mesh = mesh
        if mesh is not None and not act_sharding.joined(mesh):
            raise ValueError("BatchedServer takes a joined mesh "
                             "(launch.mesh.join_host_mesh)")
        self.policy = None if mesh is None else act_sharding.ActivationPolicy(
            moe_dispatch="shard_map", mesh=mesh)
        self.device = resolve_device(
            device or (mesh.device if mesh is not None else None),
            "BatchedServer")
        if params is None:
            self.serving = lm.init_params(prng.prng_key(seed), cfg,
                                          device=self.device, serving=True,
                                          mesh=mesh)
        else:
            self.serving = lm.serving_params(
                tree_map(lambda t: t.to(self.device), params), cfg)
        if mesh is not None and cfg.moe is not None:
            held = {t.shape[1] for path, t in flatten(self.serving)   # (L, E..)
                    if path.rsplit("/", 1)[-1] in moe.EXPERT_LEAVES}
            if held != {cfg.moe.n_experts // mesh.tp_size}:
                raise ValueError(f"rank {mesh.rank} of {mesh.shape} holds "
                                 f"{sorted(held)} experts a layer, not "
                                 f"E/tp = {cfg.moe.n_experts} / "
                                 f"{mesh.tp_size}")

    def sharded(self):
        """The context the server's model calls run in: its mesh's
        shard_map policy, or nothing without a mesh."""
        return (act_sharding.policy(self.policy) if self.policy is not None
                else contextlib.nullcontext())

    def serving_bytes(self) -> int:
        """The bytes of this rank's serving copy (the whole copy without a
        mesh)."""
        return sum(t.numel() * t.element_size()
                   for t in leaves(self.serving))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _agree(self, tok, step: int):
        """Raise unless every rank of the mesh chose the same tokens."""
        if self.mesh is None:
            return
        import torch.distributed as dist
        got = [torch.empty_like(tok) for _ in range(self.mesh.size)]
        dist.all_gather(got, tok, group=self.mesh.group)
        if not bool(torch.stack(got).eq(tok).all()):
            raise RuntimeError(
                f"rank {self.mesh.rank}: the ranks chose different tokens "
                f"at step {step}: "
                f"{[t[:, 0].tolist() for t in got]}")

    @torch.inference_mode()
    def memory(self, B: int):
        """The cross-attention memory a `generate` of B prompts feeds, as
        the reference's server: zero patch embeddings (vlm), the
        encoding of zero frames (enc-dec), else None."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "vlm":
            return torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                               dtype=cfg.cdtype, device=dev)
        if cfg.encoder is not None:
            frames = torch.zeros((B, cfg.encoder.n_frames, cfg.d_model),
                                 dtype=torch.float32, device=dev)
            with self.sharded():
                return lm.encode(self.serving, frames, cfg)
        return None

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, gen_tokens: int,
                 greedy: bool = True, seed: int = 0):
        """prompts: (B, P) int32. Returns ((B, gen_tokens) int32, stats):
        prefill and decode seconds (host clock, to a synchronize) and
        generated tokens per decode second. `greedy=False` samples as the
        reference does: from key = prng_key(seed), each step splits
        (key, k) = split(key) and takes `jax.random.categorical(k,
        logits)` over the (B, V) logits."""
        cfg, dev, params = self.cfg, self.device, self.serving
        B, P = prompts.shape
        memory = self.memory(B)
        tokens = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)
        self._sync()
        t0 = time.perf_counter()
        with self.sharded():
            logits, cache = lm.prefill(params, tokens, cfg,
                                       max_len=P + gen_tokens, memory=memory)
        self._sync()
        prefill_s = time.perf_counter() - t0
        out = torch.zeros((B, gen_tokens), dtype=torch.int64, device=dev)
        key = prng.prng_key(seed)
        tok = logits.argmax(-1)[:, None]
        t0 = time.perf_counter()
        for t in range(gen_tokens):
            self._agree(tok, t)
            out[:, t] = tok[:, 0]
            with self.sharded():
                logits, cache = lm.decode_step(params, tok, cache, cfg,
                                               P + t)
            if greedy:
                tok = logits.argmax(-1)[:, None]
            else:
                key, k = prng.split(key)
                tok = threefry.categorical(k, logits)[:, None]
        self._sync()
        decode_s = time.perf_counter() - t0
        return out.cpu().numpy().astype(np.int32), {
            "prefill_s": prefill_s, "decode_s": decode_s,
            "tok_per_s": B * gen_tokens / max(decode_s, 1e-9)}


def _prompts(cfg, requests, prompt_len):
    rng = np.random.default_rng(0)
    return rng.integers(2, cfg.vocab_size,
                        (requests, prompt_len)).astype(np.int32)


def _serve_rank(mesh, cfg, requests, prompt_len, gen):
    """One rank of `main --tp N`: returns its tokens and stats."""
    server = BatchedServer(cfg, max_batch=requests, mesh=mesh,
                           max_len=prompt_len + gen)
    out, stats = server.generate(_prompts(cfg, requests, prompt_len), gen)
    return out, {**stats, "rank_bytes": server.serving_bytes()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path; CUDA by default")
    ap.add_argument("--tp", type=int, default=0,
                    help="serve across N ranks, one card each (NCCL; with "
                         "--device cpu, N gloo ranks on the CPU), the "
                         "experts split N ways")
    args = ap.parse_args()
    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = registry.reduced(cfg)
    if args.tp:
        cpu = args.device == "cpu"
        if not cpu and torch.cuda.device_count() < args.tp:
            raise SystemExit(f"--tp {args.tp} takes {args.tp} cards; "
                             f"{torch.cuda.device_count()} found")
        results = mesh_lib.spawn_ranks(
            _serve_rank, args.tp, (cfg, args.requests, args.prompt_len,
                                   args.gen),
            backend="gloo" if cpu else "nccl",
            devices=["cpu"] * args.tp if cpu else None)
        out, stats = results[0]
        print(f"rank 0 of {args.tp}: {stats['rank_bytes'] / 1e9:.2f} GB "
              f"of weights; ", end="")
    else:
        server = BatchedServer(cfg, max_batch=args.requests,
                               device=args.device)
        out, stats = server.generate(
            _prompts(cfg, args.requests, args.prompt_len), args.gen)
    print(f"prefill {stats['prefill_s']:.2f}s decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.0f} tok/s) sample: {out[0, :10].tolist()}")


if __name__ == "__main__":
    main()
