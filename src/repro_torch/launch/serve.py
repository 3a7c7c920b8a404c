"""Batched LM server: prefill a static batch of prompts into KV/SSM
caches from `lm.init_cache`, then decode in lockstep (the reference's
`repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --smoke --requests 8 --prompt-len 64 --gen 32 [--device cpu]

It runs on CUDA unless given `device="cpu"` (`--device cpu`), and raises
without a CUDA device otherwise. Attention goes through the
flash-attention kernel and a Mamba prefill through the scan kernel
(`kernels.ops`); everything else is eager torch (no `torch.compile`, no
CUDA graph). The server decodes from its serving copy of the weights
(`lm.serving_params`): cast once from given parameters, or, from a seed,
drawn as that copy (`lm.init_params(..., serving=True)`), so that the
parameters in `param_dtype` are never held on the device.

A seed gives the reference's server: its weights are
`lm.init_params(prng_key(seed))`, the reference's bit for bit, and a
sampled decode draws the reference's Gumbel noise from the same chain of
`jax.random` keys (`kernels.threefry`: the kernel on the card, its plain
version on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.core.agent import resolve_device
from repro_torch.kernels import threefry
from repro_torch.models import lm
from repro_torch.tree import tree_map


class BatchedServer:
    """Static-batch decode server (the dry-run's serve_step semantics):
    admits up to `max_batch` requests, prefills them together, then decodes
    lockstep.

    `params`: the parameters (`lm.init_params`'s tree, e.g. a reference's
    carried across by `checkpoint.lm_params_from_numpy`), moved to the
    device and cast; without them, the serving copy of
    `lm.init_params(prng_key(seed))`, the reference server's weights,
    drawn as such on the device. The server keeps only the serving copy
    (`serving`)."""

    def __init__(self, cfg, *, max_batch: int = 8, max_len: int = 512,
                 seed: int = 0, params=None, device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device, "BatchedServer")
        if params is None:
            self.serving = lm.init_params(prng.prng_key(seed), cfg,
                                          device=self.device, serving=True)
        else:
            self.serving = lm.serving_params(
                tree_map(lambda t: t.to(self.device), params), cfg)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        logits, cache = lm.prefill(params, tokens, cfg,
                                   max_len=P + gen_tokens, memory=memory)
        self._sync()
        prefill_s = time.perf_counter() - t0
        out = torch.zeros((B, gen_tokens), dtype=torch.int64, device=dev)
        key = prng.prng_key(seed)
        tok = logits.argmax(-1)[:, None]
        t0 = time.perf_counter()
        for t in range(gen_tokens):
            out[:, t] = tok[:, 0]
            logits, cache = lm.decode_step(params, tok, cache, cfg, P + t)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path; CUDA by default")
    args = ap.parse_args()
    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = registry.reduced(cfg)
    server = BatchedServer(cfg, max_batch=args.requests, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    out, stats = server.generate(prompts, args.gen)
    print(f"prefill {stats['prefill_s']:.2f}s decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.0f} tok/s) sample: {out[0, :10].tolist()}")


if __name__ == "__main__":
    main()
