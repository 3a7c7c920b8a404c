"""The control of a training cell's check, and the faults it is read
against, at the cell's own size on one card:

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \
        [--program-seeds 21 22 ...] [--variants fp8 ...]

(a cell on four cards runs one rank a card, as its runs do).
For each of `--program-seeds` it runs the program as a run does, its
set-up and one step of window, and reads its check: the sound readings,
a dozen seeds in one process. For each of `--seeds` it draws the cell's weights and first batches as a run
does, follows them with the plain reference in float32 (what a run
compares against), and puts in the program's place:

  * "fp8": the reference computed one precision below the configuration's
    bf16 products (each product's operands rounded to float8 e4m3);
  * "half_batch": the reference with half of each batch's rows left out
    (of a batch of one row, half of its tokens);
  * "no_exchange", across cards: the reference with the sum of the ranks'
    expert outputs left out.

It prints, a line a seed and variant, the numbers a run compares
(`harness.compare`), and last the limits of the cell's workload file.
The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def variants(spec, seed, rank, names=("fp8", "half_batch")):
    """{variant: readings against the float32 reference} for one seed, on
    `rank` (a `harness.cell.Rank`: across cards, each rank its experts)."""
    import torch
    from perfbench.harness import cell, compare, weights
    from perfbench.reference import train as ref_train
    from repro_torch.models import lm
    config, traffic, work = spec["config"], spec["traffic"], spec["workload"]
    gen = cell.load_module(cell.BENCH / "generators" /
                           f"{traffic['generator']}.py")
    meta = lm.init_params(None, cell.program_config(config), device="meta")
    shapes, experts, split = cell.held_leaves(meta, rank.mesh)
    rank.first_expert = min((e[0] for e in experts.values()), default=0)

    def make_leaf(path):
        return weights.draw(path, shapes[path], seed, rank.device,
                            experts.get(path))

    batches = []
    for s in range(work["reference_steps"]):
        b = gen.batch(traffic, config["vocab_size"], seed, s)
        batches.append((torch.as_tensor(b["tokens"], device=rank.device),
                        torch.as_tensor(b["loss_mask"], device=rank.device)))
    follow = dict(cfg=config, opt=traffic["optimizer"], make_leaf=make_leaf,
                  paths=list(shapes), batches=batches, ranks=rank.ranks,
                  split=split)
    base = ref_train.follow(**follow)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        got = ref_train.follow(**follow, **PLANTED[name])
        read = compare.readings(got, base)
        out[name] = {k: v[0] for k, v in read.items()}
        out[name]["where"] = {k: v[1] for k, v in read.items()}
        out[name]["seconds"] = time.perf_counter() - t0
    return out


PLANTED = {"fp8": {"prec": "fp8"}, "half_batch": {"half_batch": True},
           "no_exchange": {"exchange": False}}


def program(spec, seed, rank):
    """The program's readings on one seed, as a run takes them."""
    from perfbench.harness import cell
    out = cell.run(spec, seed, 0.0, False, time.time(), rank)
    row = {k: v[0] for k, v in out["readings"].items()}
    row["where"] = {k: v[1] for k, v in out["readings"].items()}
    row["seconds"] = out["reference_s"]
    return row


def _rows(spec, seeds, rank, program_seeds=(), names=None):
    if names is None:
        names = ("fp8", "half_batch") + (("no_exchange",) if rank.mesh
                                         else ())
    rows = []
    for seed in program_seeds:
        rows.append({"seed": seed, "variant": "program",
                     **program(spec, seed, rank)})
        if rank.mesh is None or rank.mesh.rank == 0:
            print(json.dumps(rows[-1]), flush=True)
    for seed in seeds:
        for name, read in variants(spec, seed, rank, names).items():
            rows.append({"seed": seed, "variant": name, **read})
            if rank.mesh is None or rank.mesh.rank == 0:
                print(json.dumps(rows[-1]), flush=True)
    return rows


def _rank_rows(mesh, spec, seeds, program_seeds, names):
    import torch.distributed as dist
    from perfbench.harness import cell
    return _rows(spec, seeds, cell.Rank(
        device=mesh.device, mesh=mesh,
        flag_group=dist.new_group(backend="gloo")), program_seeds, names)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variants", nargs="+", choices=sorted(PLANTED),
                    help="what to read on each of --seeds (default: fp8 "
                    "and half_batch, and no_exchange across cards)")
    args = ap.parse_args()
    from perfbench.harness import cell
    cell.process_env()
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    spec = cell.load(args.workload)
    chips = spec["cell"]["chips"]
    if chips == 1:
        _rows(spec, args.seeds, cell.Rank(device="cuda:0"),
              args.program_seeds, args.variants)
    else:
        from repro_torch.launch.mesh import spawn_ranks
        spawn_ranks(_rank_rows, chips,
                    (spec, args.seeds, args.program_seeds, args.variants))
    print(f"limits {json.dumps(spec['workload']['limits'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
