"""Faults planted under the timed path, for the test that sees `correct`
come out false for each fault a training cell can have. None is planted
in a run of the benchmark itself.

  * "unchanged": the step returns its state as it got it;
  * "half_batch": the step sees the first half of the batch's rows only
    (of a batch of one row, the first half of its tokens), its loss the
    mean over them;
  * "no_exchange": the sum of the ranks' expert outputs left out (each
    rank goes on with its own share);
  * "double_update": an answer altered where it is produced: one leaf's
    update is applied twice.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "no_exchange", "double_update")


def wrap(step_fn, faults):
    """`step_fn` with `faults` planted."""
    faults = tuple(faults)
    bad = set(faults) - set(FAULTS)
    if bad:
        raise ValueError(f"unknown faults {sorted(bad)}")
    if not faults:
        return step_fn

    def step(params, opt_state, err, batch):
        import torch
        from repro_torch.tree import flatten
        if "half_batch" in faults:
            batch = {k: half(v) for k, v in batch.items()}
        kept = None
        if "unchanged" in faults:
            kept = [t.clone() for _, t in flatten([params, opt_state])]
        leaf = None
        if "double_update" in faults:
            leaf = max(flatten(params), key=lambda kv: kv[1].numel())[1]
            before = leaf.clone()
        with _no_exchange() if "no_exchange" in faults \
                else contextlib.nullcontext():
            params, opt_state, err, met = step_fn(params, opt_state, err,
                                                  batch)
        with torch.no_grad():
            if kept is not None:
                for (_, t), old in zip(flatten([params, opt_state]), kept):
                    t.copy_(old)
            if leaf is not None:
                leaf.add_(leaf - before)
        return params, opt_state, err, met
    return step


def half(t):
    """The first half of a batch's rows; of one row, of its tokens."""
    if t.shape[0] > 1:
        return t[:t.shape[0] // 2]
    return t[:, :t.shape[1] // 2]


@contextlib.contextmanager
def _no_exchange():
    """The program's psum over the ranks made the identity."""
    from repro_torch.sharding import act
    real = act._all_reduce
    act._all_reduce = lambda x, mesh: x
    try:
        yield
    finally:
        act._all_reduce = real
