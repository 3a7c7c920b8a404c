"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one run of
one cell of `BENCHMARK.json`.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell is a configuration (`perfbench/configs/<config>.json`) under a
traffic mix (`perfbench/traffic/<traffic>.json`, read by the generator it
names in `perfbench/generators/`), with its own settings and the limits of
its check in `perfbench/workloads/<cell>.json`; a per-layer metric is read
by `perfbench/metrics/<metric>.py`. All are found by the names in
`BENCHMARK.json`.

A run sets up (weights drawn from the seed on the card, the program's
kernels built or loaded from `build/` inside the checkout, the first
steps), measures for `--seconds`, with `--trace 1` traces a few more
steps, checks what the first steps produced against the plain reference
(`perfbench/reference/`) and prints one JSON line last on stdout: the
cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`. A cell on 4 chips runs one rank a card (NCCL); rank 0
prints. Without CUDA, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _rank_main(mesh, spec, seed, seconds, trace, started):
    """One rank of a cell across cards: its run on its card."""
    import torch
    import torch.distributed as dist
    from perfbench.harness import cell
    torch.set_num_threads(cell.THREADS)
    flags = dist.new_group(backend="gloo")
    rank = cell.Rank(device=mesh.device, mesh=mesh, flag_group=flags)
    out = cell.run(spec, seed, seconds, trace, started, rank)
    tr = out["trace"]
    out["busy_s"] = tr.busy_s() if tr is not None else None
    if mesh.rank != 0:
        out = {k: out[k] for k in ("memory_peak_bytes", "busy_s", "kind",
                                   "correct")}
    return out


def metrics_line(spec, out, trace, chips):
    """The result's metrics, from rank 0's readings."""
    from perfbench.harness import cell
    from perfbench.work.flops import step_flops
    traffic = spec["traffic"]
    if not trace:
        tokens = traffic["batch"] * traffic["seq"] * out["steps"]
        values = {
            "train_tokens_per_s": tokens / out["window_s"],
            "train_step_p90_ms": statistics.quantiles(
                out["step_s"], n=10, method="inclusive")[8] * 1e3,
            "setup_s": out["setup_s"],
        }
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in spec["end_to_end"]}

    ctx = types.SimpleNamespace(
        trace=out["trace"], chips=chips,
        config=spec["config"], traffic=traffic, step_flops=step_flops(
            spec["config"], traffic["batch"], traffic["seq"]))
    got = {}
    for m in spec["per_layer"]:
        reader = cell.load_module(cell.BENCH / "metrics" /
                                  f"{m['name']}.py")
        value = reader.read(ctx)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench.harness import cell
    cell.process_env()

    import torch
    spec = cell.load(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.set_num_threads(cell.THREADS)
    trace = bool(args.trace)
    if chips == 1:
        out = cell.run(spec, args.seed, args.seconds, trace, STARTED,
                       cell.Rank(device="cuda:0"))
        tr = out["trace"]
        peaks = [out["memory_peak_bytes"]]
        busy = [tr.busy_s()] if tr is not None else []
        kinds = [out["kind"]]
        all_correct = out["correct"]
    else:
        from repro_torch.launch.mesh import spawn_ranks
        ranked = spawn_ranks(_rank_main, chips, (
            spec, args.seed, args.seconds, trace, STARTED))
        out, tr = ranked[0], ranked[0]["trace"]
        peaks = [r["memory_peak_bytes"] for r in ranked]
        busy = [r["busy_s"] for r in ranked if r["busy_s"] is not None]
        kinds = [r["kind"] for r in ranked]
        all_correct = all(r["correct"] for r in ranked)

    from perfbench.harness import compare
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that reports: {found}",
              file=sys.stderr)
        return 4
    if len(set(kinds)) != 1:
        print(f"the ranks ran on different cards: {kinds}", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": kinds[0], "count": chips,
              "memory_peak_bytes": max(peaks)}
    result = {"correct": all_correct, "attempted": out["steps"],
              "failed": out["failed"],
              "metrics": metrics_line(spec, out, trace, chips),
              "device": device}
    if trace:
        device["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        device["window_s"] = tr.wall_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    checks = compare.lines(out["readings"], out["limits"])
    result["checks"] = {n: {"value": out["readings"][n][0],
                            "limit": out["limits"][n]}
                        for n in compare.NAMES if n in out["limits"]}
    print(f"reference {out['reference_s']:.1f} s, window "
          f"{out['window_s']:.3f} s, {out['steps']} steps, setup "
          f"{out['setup_s']:.3f} s", file=sys.stderr)
    print("setup by the end of each part, s: " + json.dumps(
        {k: round(v, 3) for k, v in out["setup_parts"].items()}),
        file=sys.stderr)
    for line in checks:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
