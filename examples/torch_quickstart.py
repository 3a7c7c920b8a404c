"""Quickstart of the PyTorch port: the public API in 60 lines, the
counterpart of examples/quickstart.py.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card unless given --device cpu.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.agent import resolve_device
from repro_torch.models import lm
from repro_torch.tree import leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_quickstart")

    # ---- 1. pick any assigned architecture; reduced() gives a small twin
    cfg = registry.reduced(registry.get_config("qwen3-8b"))
    print(f"arch: {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model})")

    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    n = sum(x.numel() for x in leaves(params))
    print(f"params: {n/1e6:.2f}M")

    # ---- 2. training step (loss + grads)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev, dtype=torch.int32)
    loss, metrics = lm.loss_fn(params, {"tokens": tokens}, cfg)
    print(f"initial loss: {float(loss):.3f} "
          f"(ln V = {np.log(cfg.vocab_size):.3f})")

    # ---- 3. serving: prefill a prompt, decode greedily
    with torch.inference_mode():
        logits, cache = lm.prefill(params, tokens[:, :32], cfg, max_len=40)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out = []
        for t in range(6):
            logits, cache = lm.decode_step(params, tok, cache, cfg, 32 + t)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
    print(f"greedy continuation: {out}")

    # ---- 4. the paper's optimizer: run one query adaptively (host code)
    from repro_torch.baselines import run_spark_default
    from repro_torch.sql import datagen, workloads
    from repro_torch.sql.cbo import Estimator

    db = datagen.make_job_like(scale=0.1, seed=0)
    wl = workloads.make_workload("job", n_train=4, n_test_per_template=1)
    res = run_spark_default(db, wl.test[0], Estimator(db, db.stats))
    print(f"query {wl.test[0].name}: {res.latency:.2f}s simulated, "
          f"{res.total_shuffles} shuffles, {len(res.stages)} stages")
    print(f"quickstart OK on {dev}")


if __name__ == "__main__":
    main()
