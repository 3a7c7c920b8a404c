"""Count on `meta` (no card) the peak live GB of the train steps and
serves that decide which depths of the LM configurations fit an 80 GB
H100: one card, or rank 0 of four (a (1, 4) mesh, each rank its E/4
experts of every MoE layer, as chip_smoke.py's shard phase runs them).
Run from the repository root:

    python3 tools/train_counts.py

Each row is `launch.dryrun.count_train(cfg, B, S)` (fp32 parameters,
gradients, both AdamW moments and the step's transients) or
`launch.dryrun.count_serve(cfg, 8, 128, 32)` (the bf16 serving copy, the
prefill and decode steps of the lm and shard phases' `generate`), at a
cut of the published config: the first `layers` layers, as
chip_smoke.py's `shard_cfg` takes them (a cut below one superblock keeps
the pattern's first layers), or whole superblocks and then the first
layers of the next (a serving cut inside a superblock). Prints one JSON
object a row and takes a few minutes of one core.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

FOUR = Mesh(("data", "model"), (1, 4), rank=0)
LLAMA4, JAMBA = "llama4-scout-17b-a16e", "jamba-1.5-large-398b"
# (kind, arch, layers, batch, seq, mesh)
ROWS = [("train", "qwen1.5-4b", None, 2, 512, None),
        ("train", "qwen1.5-4b", None, 256, 16, None),
        ("train", "qwen1.5-4b", None, 256, 32, None),
        ("train", "qwen1.5-4b", None, 256, 64, None),
        *[("train", "falcon-mamba-7b", n, 2, 512, None)
          for n in (16, 24, 32, 36)],
        *[("train", LLAMA4, 4, 1, s, FOUR) for s in (256, 1024)],
        *[("train", JAMBA, n, 1, s, FOUR) for n in (4, 5, 8)
          for s in (1024, 256)],
        *[("serve", JAMBA, n, 8, 128, FOUR) for n in range(16, 25)]]


def cut(arch, layers):
    """`arch` at its first `layers` layers (None: whole)."""
    cfg = registry.get_config(arch)
    if layers is None:
        return cfg
    n = len(cfg.block_pattern)
    whole, part = divmod(layers, n)
    if part == 0:
        return dataclasses.replace(cfg, n_layers=layers)
    if whole == 0:
        return dataclasses.replace(cfg, n_layers=layers,
                                   block_pattern=cfg.block_pattern[:part])
    # whole superblocks and the first layers of the next, as one superblock
    # of the same layers: the same leaves and bytes
    return dataclasses.replace(
        cfg, n_layers=layers,
        block_pattern=cfg.block_pattern * whole + cfg.block_pattern[:part])


def main():
    for kind, arch, layers, B, S, mesh in ROWS:
        cfg = cut(arch, layers)
        t0 = time.perf_counter()
        if kind == "train":
            counter = dryrun.count_train(cfg, B, S, mesh=mesh)
        else:            # a descriptor mesh counted as joined, as count_train
            counter = dryrun.count_serve(
                cfg, B, S, 32, mesh=dataclasses.replace(mesh, group="meta"))
        print(json.dumps({
            "kind": kind, "arch": arch, "layers": cfg.n_layers,
            "published_layers": registry.get_config(arch).n_layers,
            "batch": B, "seq": S, "ranks": 1 if mesh is None else 4,
            "peak_gb": counter.peak_live_bytes / 1e9,
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
