"""Plane B demo on the PyTorch port: AQORA's loop on execution layouts,
the counterpart of examples/adaptive_layout.py.

The re-optimizer walks one-knob modifications of a training cell's layout
(attention sharding axis, remat policy, CE chunking, int8 grad reduction,
...), using the analytic napkin-math predictor as its fast environment:
each hypothesis is printed as the re-optimizer logs it. The baseline's
roofline terms come from the port's dry run of qwen3-8b x train_4k (the
step counted op by op on the `meta` device under the H100 roofline,
`launch.dryrun`), or from --terms. Pass --real to check the chosen
layout with a dry run of its own.

  PYTHONPATH=src python examples/torch_adaptive_layout.py [--real]
      [--terms COMPUTE MEMORY COLLECTIVE] [--device cpu]

The dry run needs no card and allocates nothing; --device only names
where the counted program would run (cuda by default), and without a
card the example asks for --device cpu as the others do.
"""
import argparse
import pathlib

from repro_torch.adapt.knobs import BASELINE
from repro_torch.adapt.search import predict_delta
from repro_torch.core.agent import resolve_device

OUT = pathlib.Path(__file__).resolve().parents[1] / "results" / "perf_h100"


def baseline_terms():
    from repro_torch.launch.dryrun import run_cell
    r = run_cell("qwen3-8b", "train_4k", verbose=False)["roofline"]
    return {"compute": r["t_compute_s"], "memory": r["t_memory_s"],
            "collective": r["t_collective_s"], "bound": r["t_bound_s"],
            "bottleneck": r["bottleneck"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--terms", type=float, nargs=3, default=None,
                    metavar=("COMPUTE", "MEMORY", "COLLECTIVE"),
                    help="baseline roofline terms in seconds, in place of "
                         "the dry run's")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    resolve_device(args.device, "torch_adaptive_layout")

    if args.terms is None:
        cur = baseline_terms()
    else:
        terms = dict(zip(("compute", "memory", "collective"), args.terms))
        cur = {**terms, "bound": max(terms.values()),
               "bottleneck": max(terms, key=terms.get)}
    layout = BASELINE
    print(f"baseline {layout.name()}: {cur}")
    for it in range(4):
        cands = []
        for nb in layout.neighbors("train"):
            txt, pred = predict_delta(cur, nb, layout, "train")
            terms = {k: cur[k] * pred[k] for k in ("compute", "memory", "collective")}
            cands.append((max(terms.values()), nb, txt, terms))
        cands.sort(key=lambda c: c[0])
        bound, nb, txt, terms = cands[0]
        if bound >= cur["bound"]:
            print("no flip predicted to improve the bound; stopping")
            break
        print(f"\niter {it}: hypothesis — {txt}")
        print(f"  flip to {nb.name()}: predicted bound "
              f"{cur['bound']:.2f}s -> {bound:.2f}s")
        layout = nb
        cur = {**terms, "bound": bound,
               "bottleneck": max(terms, key=terms.get)}
    print(f"\nchosen layout: {layout.name()}")
    if args.real:
        from repro_torch.adapt.search import LayoutReoptimizer
        opt = LayoutReoptimizer("qwen3-8b", "train_4k", out_dir=OUT)
        rec = opt.evaluate(layout)
        print("counted (one H100, meta):", rec["roofline"],
              "fits:", rec["fits"])


if __name__ == "__main__":
    main()
