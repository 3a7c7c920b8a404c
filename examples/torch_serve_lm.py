"""Batched serving with the PyTorch port: prefill + lockstep decode with
KV/SSM caches, on the attention-free falcon-mamba family (O(1) decode
state), the counterpart of examples/serve_lm.py.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Runs on the CUDA card unless given --device cpu.
"""
import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.launch.serve import BatchedServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen-tokens", type=int, default=24)
    args = ap.parse_args()
    cfg = registry.reduced(registry.get_config("falcon-mamba-7b"))
    server = BatchedServer(cfg, max_batch=4, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size,
                           (4, args.prompt_len)).astype(np.int32)
    out, stats = server.generate(prompts, args.gen_tokens)
    print(f"prefill: {stats['prefill_s']:.2f}s  decode: "
          f"{stats['decode_s']:.2f}s ({stats['tok_per_s']:.0f} tok/s on "
          f"{server.device})")
    print(f"generated: {out[0].tolist()}")


if __name__ == "__main__":
    main()
