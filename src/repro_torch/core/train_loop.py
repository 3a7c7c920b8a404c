"""AQORA training + evaluation loops (§V-A4, §VII-A4c).

train_agent: episodes over the training workload with the curriculum
schedule. Serial (`batch_size=1`): one PPO update per completed query (the
paper replays the k-step trajectory after each query, Alg. 1). Batched
(`batch_size=B`): B queries run in lockstep through the vectorized rollout
engine — one policy forward per stage boundary for the whole batch — and
their trajectories are replayed by ONE PPO update per episode-batch
(Alg. 1 semantics per trajectory are unchanged; only the dispatch is
amortized). The agent it builds runs on `device` (None: CUDA, as
everywhere in the port); on the card each update's losses go forward
and backward through the fused encoder's kernels.

evaluate: run test queries with the trained policy (argmax, no
exploration); returns per-query RunResults for the benchmark tables.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.actions import curriculum_stage
from repro_torch.core.agent import AgentConfig, AqoraAgent
from repro_torch.core.encoding import WorkloadMeta
from repro_torch.core.rollout import rollout
from repro_torch.core.vec_rollout import rollout_batch
from repro_torch.sql.catalog import Database
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.workloads import Workload

# training progress goes through logging, NOT stdout: the background
# learner runs this machinery during serving, and a print would land in
# the middle of the service's output stream. Callers that want the old
# behavior opt in via logging.basicConfig(level=logging.INFO).
log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class EpisodeLog:
    episode: int
    query: str
    latency: float
    failed: bool
    actions: List
    rewards: List[float]
    actor_loss: float
    critic_loss: float
    stage: int


def train_agent(db: Database, workload: Workload, *,
                episodes: int = 300, seed: int = 0,
                cfg: Optional[AgentConfig] = None,
                cluster: Optional[ClusterModel] = None,
                est: Optional[Estimator] = None,
                use_curriculum: bool = True,
                agent=None,
                batch_size: int = 1,
                log_every: int = 0,
                device=None) -> Tuple[AqoraAgent, List[EpisodeLog]]:
    cfg = cfg if cfg is not None else AgentConfig()
    cluster = cluster if cluster is not None else ClusterModel()
    meta = WorkloadMeta.from_workload(workload)
    if agent is None:
        agent = AqoraAgent(meta, cfg, seed=seed, device=device)
    est = est or Estimator(db, db.stats)
    rng = np.random.default_rng(seed)
    logs: List[EpisodeLog] = []

    def log_progress(ep_start, n_eps, stage, m):
        # fire when this (batch of) episode(s) crosses a log_every boundary,
        # so batched runs keep the serial cadence for any log_every
        if log_every and \
                (ep_start + n_eps) // log_every > ep_start // log_every:
            recent = logs[-log_every:]
            lat = np.mean([l.latency for l in recent])
            fails = sum(l.failed for l in recent)
            log.info("  ep %4d stage=%d mean_lat=%7.2fs fails=%d "
                     "aloss=%+.3f", ep_start + n_eps, stage, lat, fails,
                     m["actor_loss"])

    ep = 0
    while ep < episodes:
        stage = curriculum_stage(ep, episodes, cfg.curriculum) \
            if use_curriculum else 3
        if batch_size <= 1:
            q = workload.train[int(rng.integers(len(workload.train)))]
            traj = rollout(db, q, est, agent, stage=stage, explore=True,
                           cluster=cluster)
            m = agent.ppo_update(traj)
            logs.append(EpisodeLog(ep, q.name, traj.t_execute, traj.failed,
                                   traj.decoded, traj.rewards,
                                   m["actor_loss"], m["critic_loss"], stage))
            log_progress(ep, 1, stage, m)
            ep += 1
            continue
        # ---- lockstep episode-batch: B rollouts, ONE PPO update
        bs = min(batch_size, episodes - ep)
        qs = [workload.train[int(rng.integers(len(workload.train)))]
              for _ in range(bs)]
        seeds = [int(rng.integers(2 ** 31)) for _ in range(bs)]
        trajs = rollout_batch(db, qs, est, agent, stage=stage, explore=True,
                              cluster=cluster, seeds=seeds)
        if hasattr(agent, "ppo_update_batch"):
            m = agent.ppo_update_batch(trajs)
        else:                              # e.g. DQN: per-trajectory replay
            for traj in trajs:
                m = agent.ppo_update(traj)
        for i, (q, traj) in enumerate(zip(qs, trajs)):
            logs.append(EpisodeLog(ep + i, q.name, traj.t_execute,
                                   traj.failed, traj.decoded, traj.rewards,
                                   m["actor_loss"], m["critic_loss"], stage))
        log_progress(ep, bs, stage, m)
        ep += bs
    return agent, logs


def evaluate(db: Database, queries, agent: AqoraAgent, *,
             est: Optional[Estimator] = None,
             cluster: Optional[ClusterModel] = None,
             batch_size: int = 1,
             policy: Optional[str] = None) -> List[Dict]:
    """Run test queries with the trained policy (argmax, no exploration).

    policy=None keeps the legacy paths: serial rollouts (batch_size=1) or
    barriered lockstep chunks (batch_size>1). policy="async"/"lockstep"
    routes the whole set through the online serving scheduler
    (`serve.scheduler.LaneScheduler`) with batch_size lanes — per-query
    plans and latencies are identical across all paths; only scheduling
    (and therefore host batching) differs.
    """
    cluster = cluster if cluster is not None else ClusterModel()
    est = est or Estimator(db, db.stats)
    if policy is not None:
        from repro_torch.serve.scheduler import Arrival, LaneScheduler
        sched = LaneScheduler(db, est, agent, n_lanes=max(batch_size, 1),
                              stage=3, explore=False, cluster=cluster,
                              policy=policy)
        comps = sched.run([Arrival(0.0, query=q, seed=i)
                           for i, q in enumerate(queries)])
        trajs = [c.traj for c in comps]
    elif batch_size > 1:
        trajs = []
        for i in range(0, len(queries), batch_size):
            trajs += rollout_batch(db, queries[i:i + batch_size], est, agent,
                                   stage=3, explore=False, cluster=cluster)
    else:
        trajs = [rollout(db, q, est, agent, stage=3, explore=False,
                         cluster=cluster) for q in queries]
    out = []
    for q, traj in zip(queries, trajs):
        r = traj.result
        out.append({
            "query": q.name, "latency": r.latency, "plan_time": r.plan_time,
            "total": r.total, "failed": r.failed,
            "failure_kind": r.failure_kind, "actions": traj.decoded,
            "shuffles": r.total_shuffles,
            "shuffle_bytes": r.total_shuffle_bytes, "bushy": r.bushy,
        })
    return out
