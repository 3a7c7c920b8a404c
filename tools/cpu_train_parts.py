"""The CPU side of chip_smoke.py's card-against-CPU train comparisons,
timed on the host's CPU at their size: the first LAYERS layers of ARCH
at its published widths with its embedding and head, fp32, filled from
a seeded block of normals (sigma 0.02; gradients 1e-3). Run from the
repository root:

    python3 tools/cpu_train_parts.py adamw [--arch qwen3-8b] [--layers 2]
    python3 tools/cpu_train_parts.py profile [--arch qwen3-8b] [--layers 2]

`adamw`: the port's AdamW update over groups of several sizes
(`optim.adamw.CHUNK` and `CPU_CHUNK`, `--chunks` as log2): for each,
fresh zero moments (their pages first touched by the first update, as in
the comparison), then two updates, each timed; after them a checksum of
every leaf of the parameters, m and v (the int64 sum of its fp32 words),
which must be the same at every group size: an element's arithmetic
does not depend on its group.

`profile`: the train step of chip_smoke.py's cells
(`launch.train.make_train_step`, lr 3e-4 over 4 steps) on one row of
`--tokens` tokens (with the driver's zero frames or memory, `batch_on`):
two steps run plain (the first touches every fresh page), then a third
under torch.profiler (CPU activities): each step's seconds, the
profiled step's ops by self CPU time (the top ones, their calls and
input shapes), and its forward and backward (`loss_and_grads`) and
AdamW seconds.

Each prints one JSON object with the intra-op threads, the CPU's vector
capability and, where nvidia-smi answers, the card's name and power
limit (the host it was timed on).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.train import batch_on, make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw, adamw_init  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

BLOCK = 1 << 20
TOP = 20


def filled(shape, block):
    """A tensor of `shape` tiled with `block`."""
    t = torch.empty(shape)
    flat = t.view(-1)
    n = flat.numel()
    whole = n - n % BLOCK
    flat[:whole].view(-1, BLOCK).copy_(block)
    flat[whole:].copy_(block[:n - whole])
    return t


def checksum(tree) -> list:
    return [int(t.view(torch.int32).sum(dtype=torch.int64))
            for t in leaves(tree)]


def card() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0]


def adamw_chunks(cfg, chunks, block) -> dict:
    shapes = lm.init_params(None, cfg, device="meta")
    p0 = tree_map(lambda t: filled(t.shape, 0.02 * block), shapes)
    grads = tree_map(lambda t: filled(t.shape, 1e-3 * block.flip(0)),
                     shapes)
    params = tree_map(torch.clone, p0)
    rows, sums = [], None
    saved = adamw.CHUNK, adamw.CPU_CHUNK
    try:
        for log2 in chunks:
            adamw.CHUNK = adamw.CPU_CHUNK = 1 << log2
            for p, q in zip(leaves(params), leaves(p0)):
                p.copy_(q)
            state = adamw_init(params)
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                adamw.adamw_update(params, grads, state,
                                   AdamWConfig(lr=3e-4))
                times.append(time.perf_counter() - t0)
            got = checksum([params, state["m"], state["v"]])
            sums = sums or got
            rows.append({"chunk_log2": log2, "update_s": times,
                         "same_as_first": got == sums})
            del state
    finally:
        adamw.CHUNK, adamw.CPU_CHUNK = saved
    if not all(r["same_as_first"] for r in rows):
        raise SystemExit(f"a group size changed the update: {rows}")
    return {"params": sum(t.numel() for t in leaves(p0)), "chunks": rows}


def step_profile(cfg, tokens, block, gen) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    params = tree_map(lambda t: filled(t.shape, 0.02 * block),
                      lm.init_params(None, cfg, device="meta"))
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=3e-4), 4)
    batch = batch_on({"tokens": torch.randint(
        0, cfg.vocab_size, (1, tokens), generator=gen).int()}, cfg, "cpu")
    saved = steps_lib.loss_and_grads, steps_lib.adamw_update

    def labelled(fn, name):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    steps_lib.loss_and_grads = labelled(saved[0], "fwd_bwd")
    steps_lib.adamw_update = labelled(saved[1], "adamw")
    times = []
    try:
        for s in range(3):
            t0 = time.perf_counter()
            if s < 2:
                params, opt, _, _ = step_fn(params, opt, 0, batch)
            else:
                with profile(activities=[ProfilerActivity.CPU],
                             record_shapes=True) as prof:
                    params, opt, _, _ = step_fn(params, opt, 0, batch)
            times.append(time.perf_counter() - t0)
    finally:
        steps_lib.loss_and_grads, steps_lib.adamw_update = saved
    ops = prof.key_averages(group_by_input_shape=True)
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:TOP]
    return {"tokens": tokens, "step_s": times,
            "profiled_parts_s": {e.key: e.cpu_time_total / 1e6
                                 for e in prof.key_averages()
                                 if e.key in ("fwd_bwd", "adamw")},
            "top_self_s": [{"op": e.key,
                            "self_s": e.self_cpu_time_total / 1e6,
                            "calls": e.count,
                            "shapes": str(e.input_shapes)[:160]}
                           for e in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("adamw", "profile"))
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=[25, 22, 20, 18], help="log2 of a group's size")
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args()
    cfg = dataclasses.replace(registry.get_config(args.arch),
                              n_layers=args.layers)
    gen = torch.Generator().manual_seed(0)
    block = torch.randn(BLOCK, generator=gen)
    out = adamw_chunks(cfg, args.chunks, block) if args.what == "adamw" \
        else step_profile(cfg, args.tokens, block, gen)
    print(json.dumps({
        "what": args.what, "arch": args.arch, "layers": args.layers,
        "threads": torch.get_num_threads(),
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "card": card(), **out}))


if __name__ == "__main__":
    main()
