"""Background PPO learner: closes the serve→train loop.

The learner rides the scheduler's completion hook, so "background" means
interleaved with scheduler ticks on the virtual clock, not a thread:
every K-th completion it draws a prioritized sample from the replay
buffer and runs ONE deterministic `ppo_update_batch` on its own copy of
the agent (the serving agent's params are never touched by training —
updates donate buffers to XLA, swaps always deep-copy). Every
`gate_every` updates the candidate faces the `PolicyStore` gate:
shadow-eval on the held-out probe set against the incumbent on the live
(possibly drifted) database, hot-swap only if no worse, learner reset to
the incumbent on reject. The whole loop — sampling, updates, gate
verdicts, swaps, curriculum promotions — is a deterministic function of
(stream, seeds), so a served run is bit-reproducible with learning on.

Budgeting: one bounded-size update per `update_every` completions keeps
the host-side learning cost a small, tunable fraction of serving work;
none of it lands on the virtual clock, so reported query latencies are
scheduling-identical to a learning-off run until a swap changes the
policy (which is the point).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import agent_state, install_agent_state
from repro_torch.learn.curriculum import AdaptiveCurriculum
from repro_torch.learn.harvest import TrajectoryHarvester
from repro_torch.learn.policy_store import PolicyStore
from repro_torch.learn.replay import ReplayBuffer

log = logging.getLogger("repro_torch.learn")


@dataclasses.dataclass
class LearnStats:
    completions: int = 0
    updates: int = 0
    gates: int = 0
    swaps: int = 0
    rejects: int = 0
    host_seconds: float = 0.0          # total learning cost (updates+gates)
    final_stage: int = 3

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["host_seconds"] = round(d["host_seconds"], 4)
        return d


class BackgroundLearner:
    def __init__(self, serving_agent, replay: ReplayBuffer, *,
                 store: Optional[PolicyStore] = None,
                 curriculum: Optional[AdaptiveCurriculum] = None,
                 update_every: int = 8, sample_size: int = 8,
                 gate_every: int = 2, min_buffer: Optional[int] = None,
                 seed: int = 0, reset_on_reject: bool = True,
                 learner_agent=None,
                 explore_below_stage: Optional[int] = None):
        """update_every  run one PPO update per this many completions
        sample_size     trajectories per update (one jitted episode-batch)
        gate_every      gate + maybe hot-swap every this many updates
        min_buffer      don't update until the buffer holds this many
        learner_agent   optional pre-built agent to train (lets callers
                        reuse a warm jit cache across runs); defaults to a
                        fresh clone of the serving agent's architecture
        explore_below_stage  with a curriculum: serve exploring while
                        curriculum.stage < this, greedy (argmax) once the
                        stage is earned — so exploration only runs while
                        the governor says the policy is still learning
                        (e.g. 3: greedy at full stage, exploring after a
                        drift-triggered demotion)
        """
        self.serving_agent = serving_agent
        self.replay = replay
        self.store = store
        self.curriculum = curriculum
        self.update_every = max(update_every, 1)
        self.sample_size = max(sample_size, 1)
        self.gate_every = max(gate_every, 1)
        self.min_buffer = sample_size if min_buffer is None else min_buffer
        self.reset_on_reject = reset_on_reject
        assert explore_below_stage is None or curriculum is not None, \
            "explore_below_stage needs a curriculum to read the stage from"
        self.explore_below_stage = explore_below_stage
        self._rng = np.random.default_rng(seed)
        if learner_agent is None and hasattr(serving_agent, "clone"):
            self.agent = serving_agent.clone(seed=seed)
        else:
            if learner_agent is None:
                learner_agent = type(serving_agent)(
                    serving_agent.meta, serving_agent.cfg, seed=seed)
            self.agent = learner_agent
            install_agent_state(self.agent, agent_state(serving_agent),
                                copy=True)
        self.stats = LearnStats(final_stage=3 if curriculum is None
                                else curriculum.stage)
        self.update_log: List[Dict] = []
        self._sched = None

    def attach(self, scheduler) -> None:
        self._sched = scheduler
        if self.store is not None and \
                getattr(self.store, "obs", None) is None:
            # wire the store's observability sink to the scheduler's
            # tracer (QueryService attaches obs before hooks, so it is
            # already installed here; None stays None)
            self.store.obs = getattr(scheduler, "obs", None)
        if self.curriculum is not None:
            scheduler.stage = self.curriculum.stage
            self._gate_explore()
        if self.store is not None and not self.store.versions:
            self.store.commit(self.serving_agent, step=0,
                              extra={"initial": True})
        scheduler.on_complete.append(self._on_complete)

    def _gate_explore(self) -> None:
        if self.explore_below_stage is not None:
            self._sched.explore = \
                self.curriculum.stage < self.explore_below_stage

    # -------------------------------------------------------------- loop
    def _on_complete(self, comp) -> None:
        t0 = time.perf_counter()
        if self.curriculum is not None:
            self._sched.stage = self.curriculum.observe(comp)
            self.stats.final_stage = self.curriculum.stage
            self._gate_explore()
        self.stats.completions += 1
        if self.stats.completions % self.update_every == 0 and \
                len(self.replay) >= self.min_buffer:
            self._update_step()
        self.stats.host_seconds += time.perf_counter() - t0

    def _update_step(self) -> None:
        exps = self.replay.sample(self.sample_size, self._rng,
                                  self._sched.db.versions)
        m = self.agent.ppo_update_batch([e.traj for e in exps])
        self.stats.updates += 1
        self.update_log.append({"update": self.stats.updates,
                                "n_traj": len(exps), **m})
        obs = getattr(self._sched, "obs", None)
        if obs is not None:
            obs.event("learner_update",
                      {"update": self.stats.updates, "n_traj": len(exps)})
        if self.store is None or self.stats.updates % self.gate_every:
            return
        self.stats.gates += 1
        rec = self.store.evaluate_and_maybe_swap(
            self.serving_agent, self.agent, db=self._sched.db,
            est=self._sched.est, cluster=self._sched.cluster,
            step=self.stats.updates)
        if rec["swapped"]:
            self.stats.swaps += 1
        elif not rec["accepted"]:
            self.stats.rejects += 1
            if self.reset_on_reject:      # restart from the incumbent
                install_agent_state(self.agent,
                                    agent_state(self.serving_agent),
                                    copy=True)
                log.info("learner reset to incumbent after gate reject "
                         "@update %d", self.stats.updates)


def make_online_loop(serving_agent, *, probe=(), store_dir=None,
                     replay: Optional[ReplayBuffer] = None,
                     curriculum: Optional[AdaptiveCurriculum] = None,
                     store: Optional[PolicyStore] = None,
                     **learner_kw):
    """Convenience factory: (harvester, learner) sharing one replay
    buffer, ready for `QueryService(hooks=[harvester, learner])` (the
    harvester must run first so the completion that triggers an update is
    already buffered)."""
    replay = replay if replay is not None else ReplayBuffer()
    if store is None and store_dir is not None:
        store = PolicyStore(store_dir, probe)
    assert not (probe and store is None), \
        "probe queries given but no store/store_dir: the gate (and any " \
        "hot-swap) would silently never run"
    harvester = TrajectoryHarvester(replay)
    learner = BackgroundLearner(serving_agent, replay, store=store,
                                curriculum=curriculum, **learner_kw)
    return harvester, learner
