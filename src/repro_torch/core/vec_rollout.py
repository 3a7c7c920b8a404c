"""Vectorized rollout engine: B queries executed in lockstep (§IV at
batch granularity — the training hot path of the framework).

Since the online serving subsystem landed, lockstep batching is a
SCHEDULER POLICY, not a separate engine: `rollout_batch` admits its B
queries as one wave into `serve.scheduler.LaneScheduler(policy=
"lockstep")`, which per tick gathers every suspended lane into ONE jitted
`agent.act_batch` call (masked categorical, per-lane PRNG advanced
in-kernel, a single device sync per step), applies Alg. 2 per lane, and
resumes each `sql.executor.AdaptiveRun` to its next stage boundary.

Lanes that finish drop out of the batch (their slots are padded with a
noop-only mask); the wave barriers until every lane has produced a
RunResult. Per-lane PRNG chains are keyed by `seeds` and advance exactly
like `core.rollout.rollout(..., key=seed)` — a seeded serial rollout, one
lane of this lockstep wave, and one async serving lane
(`LaneScheduler(policy="async")`) all take identical actions, so the
paths are interchangeable evidence-wise and differ only in scheduling.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.rollout import Trajectory
from repro_torch.serve.scheduler import Arrival, LaneScheduler
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel


def rollout_batch(db, queries: Sequence, est: Estimator, agent, *,
                  stage: int = 3, explore: bool = True,
                  cluster: Optional[ClusterModel] = None,
                  seeds: Optional[Sequence] = None) -> List[Trajectory]:
    """Run `queries` in lockstep; returns one Trajectory per query.

    `seeds[i]` keys lane i's action sampling (defaults to 0..B-1); a serial
    `rollout(db, queries[i], ..., key=seeds[i])` reproduces lane i exactly.
    """
    B = len(queries)
    if seeds is None:
        seeds = list(range(B))
    assert len(seeds) == B, "one seed per lane"
    sched = LaneScheduler(db, est, agent, n_lanes=B, stage=stage,
                          explore=explore, cluster=cluster,
                          policy="lockstep")
    comps = sched.run([Arrival(0.0, query=q, seed=s)
                       for q, s in zip(queries, seeds)])
    return [c.traj for c in comps]
