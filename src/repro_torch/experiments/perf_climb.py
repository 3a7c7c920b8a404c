"""Layout hillclimbs, as the reference's `repro.experiments.perf_climb`:
drive the reference's three cells (and `bonus_decode_cell`) with the
Plane-B re-optimizer (`adapt.search.LayoutReoptimizer`). Each iteration
re-counts the cell on the `meta` device (`launch.dryrun.run_cell`) under
the H100 roofline and logs hypothesis -> predicted -> counted -> verdict
into results/perf_h100/.

Cells (the reference's choice):
  qwen3-8b     x train_4k   — representative cell, Plane-B loop end-to-end
  dbrx-132b    x train_4k   — the reference's most collective-bound cell
  minicpm3-4b  x decode_32k — MLA's latent cache re-expanded every token

On one card the collective term is 0 and the sharding knobs
(`attn_mode`, `kv_seq_shard`) change nothing, so a flip that only moves
collectives is refuted by its count.

  python -m repro_torch.experiments.perf_climb
"""
import pathlib
import time

from repro_torch.adapt.search import LayoutReoptimizer

OUT = pathlib.Path(__file__).resolve().parents[3] / "results" / "perf_h100"
CELLS = [
    ("qwen3-8b", "train_4k", "train"),
    ("dbrx-132b", "train_4k", "train"),
    ("minicpm3-4b", "decode_32k", "decode"),
]


def climb(arch, shape, kind, max_iters):
    t0 = time.time()
    print(f"=== hillclimb {arch} x {shape} ===", flush=True)
    opt = LayoutReoptimizer(arch, shape, out_dir=OUT)
    best, logs = opt.climb(max_iters=max_iters, kind=kind)
    print(f"--- {arch} x {shape}: best layout {best.name()} "
          f"({len(logs)} iterations, {time.time()-t0:.0f}s)", flush=True)
    for l in logs:
        print(f"  it{l.iteration}: {l.layout} -> {l.verdict}")
    return best, logs


def main():
    for arch, shape, kind in CELLS:
        climb(arch, shape, kind, max_iters=8)


def bonus_decode_cell():
    """4th cell: qwen1.5-4b decode_32k (the reference's most
    collective-bound decode)."""
    return climb("qwen1.5-4b", "decode_32k", "decode", max_iters=5)


if __name__ == "__main__":
    main()
