"""The numbers that decide `correct` for a training cell, each a gap
between what the program's first steps produced and what the plain
reference gives from the same weights and batches:

  * loss_gap: the relative gap of the first step's loss. The later
    steps' gaps are printed beside it and not compared: from Adam's first
    full-rate update on, rounding that flips the sign of a near-zero
    gradient's element moves it by a whole step of the learning rate, and
    on an H100 qwen1.5-4b's third-step gap swung from 3.5e-4 to 1.2e-2
    over 16 seeds of sound runs; the slices' change (below) holds the
    updates;
  * grad_norm_gap: the relative gap of the first step's global gradient
    norm (before clipping);
  * leaf_grad_gap: the worst slice's gap of its first gradient's norm as
    the optimizer takes it (after clipping), over the larger of that
    slice's reference norm and the median slice's;
  * leaf_change_gap: the worst slice's gap of the norm of its change over
    the steps, over the larger of that slice's reference change and the
    median slice's. A slice whose reference gradient is under a
    thousandth of the median slice's (a key bias under softmax) moves by
    round-off alone and is left out of it;
  * leaf_grad_median_gap, leaf_change_median_gap: the median over the
    same slices of the same gaps. The worst slice swings with one noisy
    slice from seed to seed; the median does not.

A slice is one layer of a stacked leaf or a whole unstacked leaf. A cell
compares the numbers its workload file gives a limit, each against its
own; the others are printed and not compared.
"""
from __future__ import annotations

import math
import statistics

NEGLIGIBLE = 1e-3       # of the median slice's reference gradient

NAMES = ("loss_gap", "grad_norm_gap", "leaf_grad_gap", "leaf_change_gap",
         "leaf_grad_median_gap", "leaf_change_median_gap")


def _gaps(prog, ref, keep):
    """{slice: gap} over `keep`, each over the larger of its reference
    norm and the median slice's."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def _worst(gaps):
    if not all(math.isfinite(g) for g in gaps.values()):
        return math.inf, "a slice not finite"
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def _median(gaps):
    if not all(math.isfinite(g) for g in gaps.values()):
        return math.inf, "a slice not finite"
    return statistics.median(gaps.values()), f"{len(gaps)} slices"


def readings(prog: dict, ref: dict) -> dict:
    """{name: (value, where)}; `prog` and `ref` as `reference.train.follow`
    returns them (the program's read from its own state)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in losses):
        losses = [math.inf]
    later = " ".join(f"{x:.3e}" for x in losses[1:])
    out = {"loss_gap": (losses[0], f"step 1; later steps {later}")}
    out["grad_norm_gap"] = (abs(prog["grad_norm"] - ref["grad_norm"])
                            / ref["grad_norm"], "step 1")
    if math.isnan(out["grad_norm_gap"][0]):
        out["grad_norm_gap"] = (math.inf, "step 1")
    grads = ref["grad_slices"]
    gaps = _gaps(prog["grad_slices"], grads, list(grads))
    out["leaf_grad_gap"], out["leaf_grad_median_gap"] = (_worst(gaps),
                                                         _median(gaps))
    med = statistics.median(grads.values())
    moved = [k for k in grads if grads[k] >= NEGLIGIBLE * med]
    gaps = _gaps(prog["change_slices"], ref["change_slices"], moved)
    out["leaf_change_gap"], out["leaf_change_median_gap"] = (_worst(gaps),
                                                             _median(gaps))
    return out


def verdict(read: dict, limits: dict) -> bool:
    """Whether every number the limits name is within its limit."""
    unknown = set(limits) - set(NAMES)
    if unknown:
        raise ValueError(f"limits on unknown numbers: {sorted(unknown)}")
    if not limits:
        raise ValueError("a cell compares at least one number")
    return all(read[n][0] <= limits[n] for n in limits)


def lines(read: dict, limits: dict):
    """One line a number: its name, value, limit (or that it is not
    compared) and where it was worst."""
    return [f"{n} {read[n][0]!r} "
            + (f"limit {limits[n]!r}" if n in limits else "not compared")
            + f" ({read[n][1]})" for n in NAMES]
