"""Lifelong learning loop: train DURING serving, behind a safety gate.

The serving subsystem (`repro_torch.serve`) runs a frozen policy; this package
closes the serve→train loop the paper's online re-optimization story
needs. Five cooperating pieces, each in its own module:

  harvest.py       `TrajectoryHarvester` — opt-in hook on the scheduler's
                   completion stream; records the per-stage observations/
                   actions/rewards serving already computed, tagged with
                   per-table data versions at finish time.

  replay.py        `ReplayBuffer` — bounded, prioritized by recency ×
                   latency-regret × version freshness, so post-delta
                   experience outweighs experience from data that no
                   longer exists.

  learner.py       `BackgroundLearner` — deterministic `ppo_update_batch`
                   steps interleaved with scheduler ticks (at most one
                   update per K completions) on a CLONE of the serving
                   agent; never mutates serving params directly.

  curriculum.py    `AdaptiveCurriculum` — the paper's staged action
                   schedule driven by live rolling success-rate/latency
                   stats instead of an episode counter.

  policy_store.py  `PolicyStore` — versions params via repro_torch.checkpoint,
                   shadow-evaluates each candidate on a held-out probe
                   set against the incumbent on the live database, and
                   atomically hot-swaps the serving agent only when the
                   candidate is no worse — with rollback.

Dataflow: scheduler completions → harvester → replay → learner →
policy-store gate → (hot-swap) scheduler's agent. Everything runs on
virtual-clock event order with seeded RNGs, so a served run is
bit-reproducible with learning on. See src/repro/serve/README.md.
"""
from __future__ import annotations

_EXPORTS = {
    "Experience": "repro_torch.learn.replay",
    "ReplayBuffer": "repro_torch.learn.replay",
    "TrajectoryHarvester": "repro_torch.learn.harvest",
    "AdaptiveCurriculum": "repro_torch.learn.curriculum",
    "PolicyStore": "repro_torch.learn.policy_store",
    "BackgroundLearner": "repro_torch.learn.learner",
    "LearnStats": "repro_torch.learn.learner",
    "make_online_loop": "repro_torch.learn.learner",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)
