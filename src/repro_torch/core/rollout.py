"""Rollouts: run one query under AQE with the agent as the planner
extension (§IV workflow steps 1-4).

The hook fires at stage boundaries (and once pre-execution — AQORA's
two-phase mechanism reuses in-execution strategies at planning time), at
most `max_steps` times. Each firing: encode partial plan + true cards ->
policy -> apply action via Alg. 2 -> shaping reward from Δshuffles.
The hook's real wall time (model inference + plan transformation + any CBO
re-planning) is charged to C_plan, mirroring the paper's ~317 ms/query
optimization overhead accounting.

`rollout` drives ONE query serially. Pass `key` (an int seed or a raw
uint32[2] PRNG key) to sample through the agent's keyed path — the same
split-then-sample chain one lane of `core.vec_rollout.rollout_batch` uses,
so seeded serial and batched rollouts take identical actions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.actions import action_mask, apply_action
from repro_torch.core.encoding import WorkloadMeta, encode_state
from repro_torch.core.prng import prng_key
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.executor import RunResult, RuntimeState, run_adaptive
from repro_torch.sql.plans import syntactic_plan


@dataclasses.dataclass
class Trajectory:
    states: List = dataclasses.field(default_factory=list)
    actions: List[int] = dataclasses.field(default_factory=list)
    logps: List[float] = dataclasses.field(default_factory=list)
    masks: List[np.ndarray] = dataclasses.field(default_factory=list)
    rewards: List[float] = dataclasses.field(default_factory=list)
    decoded: List = dataclasses.field(default_factory=list)
    t_execute: float = 0.0
    failed: bool = False
    result: Optional[RunResult] = None
    hook_seconds: float = 0.0


def as_key(key) -> np.ndarray:
    """int seed or raw key -> uint32[2] PRNG key bytes (host-side)."""
    if isinstance(key, (int, np.integer)):
        return prng_key(int(key))
    return np.asarray(key, np.uint32)


def finalize_trajectory(traj: Trajectory, res: RunResult, query, est,
                        agent, cluster: ClusterModel, meta: WorkloadMeta,
                        extra_plan: float) -> Trajectory:
    """Shared epilogue: terminal critic state s_k, latency, C_plan."""
    final = res.final_plan
    if final is not None:
        s = RuntimeState(query, final, {}, est, agent.cfg.max_steps,
                         res.latency, len(res.stages), cluster)
        try:
            traj.states.append(encode_state(s, meta))
        except (KeyError, IndexError, ValueError):
            pass          # un-encodable terminal plan: critic falls back to
            #               the realized value -sqrt(T) in ppo_update
    # failed runs already carry their failure charge in res.latency (the
    # cluster's failure_charge: full timeout by default, detection time
    # under oom_charge="detect") — the learner's -sqrt(T) target matches
    # whatever the scheduler actually charged the lane
    traj.t_execute = res.latency
    traj.failed = res.failed
    # C_plan = hook wall time (model inference + Alg. 2) + CBO re-planning
    res.plan_time += traj.hook_seconds + extra_plan
    traj.result = res
    return traj


def rollout(db, query, est: Estimator, agent, *, stage: int = 3,
            explore: bool = True,
            cluster: Optional[ClusterModel] = None,
            key=None, reuse_stages: bool = True) -> Trajectory:
    cluster = cluster if cluster is not None else ClusterModel()
    traj = Trajectory()
    meta = agent.meta
    extra_plan = [0.0]
    keybox = [None if key is None else as_key(key)]

    def hook(state):
        t0 = time.perf_counter()
        enc = encode_state(state, meta)
        am = action_mask(agent.space, state, stage=stage)
        if keybox[0] is not None and hasattr(agent, "act_keyed"):
            a, logp, keybox[0] = agent.act_keyed(enc, am, keybox[0],
                                                 explore=explore)
        else:
            a, logp = agent.act(enc, am, explore=explore)
        new_plan, r, extra = apply_action(agent.space, state, a)
        traj.states.append(enc)
        traj.actions.append(a)
        traj.logps.append(logp)
        traj.masks.append(am)
        traj.rewards.append(r)
        traj.decoded.append(agent.space.decode(a))
        extra_plan[0] += extra
        traj.hook_seconds += time.perf_counter() - t0
        return new_plan

    plan0 = syntactic_plan(query)
    res = run_adaptive(db, query, plan0, est, cluster, hook=hook,
                       max_hook_steps=agent.cfg.max_steps,
                       plan_time=0.0, reuse_stages=reuse_stages)
    return finalize_trajectory(traj, res, query, est, agent, cluster, meta,
                               extra_plan[0])
