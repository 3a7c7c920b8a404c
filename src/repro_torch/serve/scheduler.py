"""Async lane scheduler: a fixed pool of lanes over resumable AdaptiveRuns.

Each lane holds at most one in-flight query, suspended at its next stage
boundary. One scheduler tick:

  1. admit — every idle lane is immediately refilled from the admission
     queue (FCFS by default; policy="edf" or an installed
     `serve.qos.AdmissionPolicy` picks earliest-deadline-first with
     fair-share tie-breaks, and may defer, degrade or reject — see
     qos/admission.py); a delta batch at the head of
     the queue is a write barrier: it applies once every previously
     admitted query has drained, and every query behind it sees the new
     table version;
  2. gather — whichever lanes are currently suspended at a stage boundary
     (optionally only those whose boundary falls inside a `window`-second
     batching horizon) are padded into ONE `agent.act_batch` call;
  3. scatter — each decided lane applies its action (Alg. 2) and resumes
     to its next boundary or to completion. A finished lane frees at its
     virtual completion time and is refilled on the next tick.

There is NO global barrier: lanes join and leave mid-flight, and a
straggler occupies exactly one lane while the others keep streaming.

Virtual time. Queries are timed on a deterministic virtual clock: a run
admitted at `admit_t` reaches its k-th boundary at `admit_t + elapsed_k`
(the executor's simulated seconds) and completes at `admit_t + latency`.
Policy decisions are free on this clock (their host cost is tracked
separately in `Trajectory.hook_seconds`), so per-query plans, latencies
and completion times are bit-reproducible for ANY lane count, batching
window or scheduling policy — serial execution (n_lanes=1) and the original
lockstep engine (policy="lockstep", which admits barriered waves of
n_lanes queries) are special cases of the same loop, and
`core.vec_rollout.rollout_batch` is now a thin wrapper over this module.

Scheduling still changes what matters for serving: under "lockstep" a
wave's lanes all wait for the slowest member before the next wave is
admitted, while "async" refills each lane the moment it frees — which is
what `benchmarks/bench_serve.py` quantifies on straggler-heavy mixes.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.actions import action_mask, apply_action
from repro_torch.core.encoding import MAX_NODES, encode_state
from repro_torch.core.rollout import Trajectory, as_key, finalize_trajectory
from repro_torch.serve.cache import PartitionedStageCache
from repro_torch.serve.deltas import DeltaBatch, apply_delta
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.executor import AdaptiveRun, RunResult
from repro_torch.sql.plans import syntactic_plan


@dataclasses.dataclass
class Arrival:
    """One item of the admission stream: a query (with its PRNG seed) or a
    delta batch, arriving at virtual time `t`. Multi-tenant streams tag
    each arrival with a `tenant` and (optionally) an absolute virtual
    `deadline`; `not_before` is written by admission deferrals (token-
    bucket rate limits) and floors the admit time."""
    t: float
    query: object = None
    seed: object = None
    delta: Optional[DeltaBatch] = None
    seq: int = -1                     # stream position, assigned by run()
    tenant: str = "default"
    deadline: Optional[float] = None  # absolute virtual-clock deadline
    not_before: float = 0.0           # admission deferral floor
    ticket: object = None             # recover.RetryTicket on re-admissions


@dataclasses.dataclass
class Completion:
    seq: int
    query: object
    seed: object
    arrival_t: float
    admit_t: float
    finish_t: float
    lane: int
    tick: int                         # scheduler tick at which it finished
    traj: Trajectory
    result: RunResult
    tenant: str = "default"
    deadline: Optional[float] = None
    hook_budget: Optional[int] = None  # None = agent default (full budget)
    degraded: bool = False             # admission shrank the hook budget
    predicted: Optional[float] = None  # admission-time latency estimate
    attempts: int = 1                  # lane admissions this query consumed
    recovered: bool = False            # succeeded after >=1 failed attempt
    hedged: bool = False               # resolved through a hedge race
    failure_kind: str = ""             # final failure kind, or (recovered)
    #                                    the kind of the FIRST failed attempt
    first_admit_t: float = 0.0         # attempt 1's admission (== admit_t
    #                                    for single-attempt queries)
    memoized: bool = False             # served by a plan-memory replay
    #                                    (zero act_batch participation)

    @property
    def latency(self) -> float:
        """Queueing + service time on the virtual clock."""
        return self.finish_t - self.arrival_t

    @property
    def service_t(self) -> float:
        return self.finish_t - self.admit_t

    @property
    def queue_wait(self) -> float:
        """Virtual time spent in the admission queue before a lane."""
        return self.admit_t - self.arrival_t

    @property
    def slo_miss(self) -> bool:
        return self.deadline is not None and self.finish_t > self.deadline


@dataclasses.dataclass
class Rejection:
    """A query turned away at admission (predicted-hopeless): it never
    occupies a lane and produces no Completion."""
    seq: int
    query: object
    seed: object
    tenant: str
    arrival_t: float
    reject_t: float                   # virtual time of the decision
    deadline: Optional[float]
    predicted: Optional[float]
    reason: str


@dataclasses.dataclass
class _Lane:
    idx: int
    free_at: float = 0.0
    run: Optional[AdaptiveRun] = None
    traj: Optional[Trajectory] = None
    state: object = None              # pending RuntimeState (None = no run)
    key: Optional[np.ndarray] = None  # uint32[2] PRNG chain head
    extra_plan: float = 0.0
    arrival: Optional[Arrival] = None
    admit_t: float = 0.0
    hook_budget: Optional[int] = None  # admission-assigned (None = full)
    degraded: bool = False
    predicted: Optional[float] = None
    memoized: bool = False             # running a plan-memory replay
    held: Optional[float] = None       # hedge-race stash: the run finished
    #   at this virtual time but its completion is deferred until the pair
    #   resolves — the lane stays occupied (blocks refill + write barriers)

    @property
    def next_event(self) -> float:
        """Virtual time of the pending stage boundary."""
        return self.admit_t + self.state.elapsed


class LaneScheduler:
    """Admits a stream of Arrivals into `n_lanes` lanes; one batched policy
    call per tick over every gathered suspension point.

    policy   "async"    — work-conserving: finished lanes refill at once.
             "edf"      — async, but idle lanes take the pending query
                          with the EARLIEST DEADLINE (ties: stream order)
                          from the segment ahead of the next write
                          barrier, instead of strict FCFS.
             "lockstep" — barriered waves of n_lanes (the original engine).
    window   batching horizon in virtual seconds: a tick decides only the
             lanes suspended within `window` of the earliest pending
             boundary (0.0 = event-ordered ticks, None = gather ALL
             suspended lanes). Affects host batching and tick ordering
             only — per-query plans, latencies and completion times are
             window-independent.
    admission  optional `serve.qos.AdmissionPolicy`: overrides the pick
             among pending queries (EDF + fair share), and may defer
             (rate limits), degrade (shrunken hook budget) or reject
             queries. None keeps the original FCFS path bit-identical.
    """

    def __init__(self, db, est: Estimator, agent, *, n_lanes: int = 4,
                 stage: int = 3, explore: bool = False,
                 cluster: Optional[ClusterModel] = None,
                 policy: str = "async", window: Optional[float] = None,
                 reuse_stages: bool = True, admission=None, recovery=None,
                 plan_memory=None):
        assert policy in ("async", "edf", "lockstep"), policy
        assert admission is None or policy != "lockstep", \
            "admission control needs per-lane refill (async/edf)"
        assert recovery is None or policy != "lockstep", \
            "the recovery plane needs per-lane refill (async/edf)"
        self.db, self.est, self.agent = db, est, agent
        self.n_lanes, self.stage, self.explore = n_lanes, stage, explore
        self.cluster = cluster if cluster is not None else ClusterModel()
        self.policy = policy
        self.window = None if policy == "lockstep" else window
        self.reuse_stages = reuse_stages
        if admission is None and policy == "edf":
            # lazy: scheduler must stay importable without pulling the
            # whole qos package at module load
            from repro_torch.serve.qos.admission import EdfPolicy
            admission = EdfPolicy()
        self.admission = admission
        self.lanes = [_Lane(i) for i in range(n_lanes)]
        self.completions: List[Completion] = []
        self.rejections: List[Rejection] = []
        self.delta_log: List[tuple] = []
        # dynamically scheduled write-barrier tasks (e.g. the drift control
        # plane's incremental re-ANALYZE): each runs like a delta — only
        # once every previously admitted query has drained — so every
        # query decides all its stages against one consistent catalog
        self._barrier_tasks: deque = deque()
        # one (barrier END time, label) entry per task run: apply time
        # plus any virtual charge the task returned — the floor later
        # admissions see (deltas in delta_log log their APPLY time)
        self.task_log: List[tuple] = []
        self.ticks = 0
        self.decide_sizes: List[int] = []
        self._write_ts = 0.0          # virtual time of the last delta apply
        # opt-in completion hooks (the lifelong-learning loop's harvest
        # point): each callback sees every Completion in deterministic
        # completion-processing order (lane order within a tick — NOT
        # necessarily sorted by virtual finish time), between policy
        # batches — never mid-`act_batch` — so a callback may mutate
        # `self.agent`'s params or `self.stage` and the change
        # deterministically takes effect from the next tick on.
        self.on_complete: List[Callable[[Completion], None]] = []
        # opt-in delta hooks: fired right after a delta batch applies (the
        # lanes are drained — it IS the write barrier), with the apply
        # time. The drift controller reacts here so a stats refresh lands
        # at the same barrier with zero extra drain: a task scheduled from
        # this hook runs before any post-delta query is admitted.
        self.on_delta: List[Callable[[float, DeltaBatch], None]] = []
        if admission is not None:     # after on_complete: attach hooks it
            admission.attach(self)
        # failure-recovery control plane (serve.recover.RecoveryManager):
        # fault profiles at _start, retry/hedge interception at _finish,
        # hedge launches each tick. None = no recovery seams on any path.
        self.recovery = recovery
        # observability plane (serve.obs.Tracer.attach sets this): every
        # emit point below is guarded by `self.obs is not None`, so
        # obs=None keeps the run bit-identical to an untraced scheduler
        self.obs = None
        # plan memory (serve.plans.PlanMemory.attach sets this): probed at
        # `_start` ahead of the agent — a hit replays the stored action
        # sequence with ZERO act_batch participation. None (or an empty
        # memory with ingest off) keeps completions bit-identical.
        self.plan_memory = None
        self._pending: deque = deque()
        if recovery is not None:
            recovery.attach(self)
        if plan_memory is not None:
            plan_memory.attach(self)

    # ------------------------------------------------------------- driving
    def run(self, stream: Sequence[Arrival]) -> List[Completion]:
        """Drain `stream` (any order; stable-sorted by arrival time) and
        return one Completion per admitted query, in stream order
        (admission-rejected queries land in `self.rejections`)."""
        # work on COPIES: admission mutates per-run state on arrivals
        # (deferral not_before, stamped default deadlines), and the
        # caller's stream must replay identically through another
        # scheduler — e.g. the QoS-off bit-identity comparisons
        stream = [dataclasses.replace(a) for a in stream]
        for i, a in enumerate(stream):
            a.seq = i
        if self.admission is not None:
            self.admission.prepare(stream)
        pending = deque(sorted(stream, key=lambda a: a.t))
        self._pending = pending       # the recovery plane requeues retries
        while True:
            self._admit(pending)
            if self.recovery is not None:
                # speculative execution claims lanes the admission queue
                # left idle (so hedges never starve real arrivals)
                self.recovery.maybe_hedge()
            susp = [l for l in self.lanes if l.state is not None]
            if not susp:
                assert not pending, "admission stalled with idle lanes"
                break
            t_min = min(l.next_event for l in susp)
            horizon = np.inf if self.window is None else t_min + self.window
            self._decide([l for l in susp if l.next_event <= horizon])
            self.ticks += 1
            if self.obs is not None:
                self.obs.on_tick(t_min)
        return sorted(self.completions, key=lambda c: c.seq)

    def schedule_barrier(self, fn: Callable, label: str = "task") -> None:
        """Schedule `fn(scheduler, t_apply)` as a write-barrier task: it
        runs once every previously admitted query has drained, at the
        virtual time the last of them frees, and every query admitted
        afterwards starts at or after that time (plus any virtual-seconds
        charge the task returns). Callable from an `on_complete` hook
        (the drift controller's trigger point), so the task lands
        deterministically between policy batches."""
        self._barrier_tasks.append((label, fn))

    # ----------------------------------------------------------- admission
    def _admit(self, pending: deque) -> None:
        while True:
            if self._barrier_tasks:
                # same drain discipline as a delta arrival: the task may
                # mutate what in-flight queries depend on (catalog stats,
                # table data), so it waits for every admitted query
                if any(l.run is not None for l in self.lanes):
                    return
                label, fn = self._barrier_tasks.popleft()
                t_apply = max([self._write_ts] +
                              [l.free_at for l in self.lanes])
                # a task may return a virtual-seconds charge (e.g. a
                # re-ANALYZE run as a foreground maintenance window):
                # queries admitted after the barrier start no earlier
                # than its end
                dt = fn(self, t_apply)
                self._write_ts = t_apply + (dt or 0.0)
                self.task_log.append((self._write_ts, label))
                if self.obs is not None:
                    self.obs.event("barrier_task",
                                   {"label": label,
                                    "charge_s": round(dt or 0.0, 6)},
                                   t=self._write_ts)
                continue
            if not pending:
                return
            item = pending[0]
            if item.delta is not None:
                # write barrier: drain every previously admitted query
                if any(l.run is not None for l in self.lanes):
                    return
                pending.popleft()
                # _write_ts participates: a delta right behind a charged
                # barrier task must not rewind the write floor into the
                # window the task just charged
                t_apply = max([item.t, self._write_ts] +
                              [l.free_at for l in self.lanes])
                counts = apply_delta(self.db, item.delta)
                self._write_ts = t_apply
                self.delta_log.append((t_apply, item.delta, counts))
                for cb in self.on_delta:
                    cb(t_apply, item.delta)
                continue
            if self.policy == "lockstep":
                if any(l.run is not None for l in self.lanes):
                    return            # wave still in flight (barrier)
                base = max([self._write_ts] +
                           [l.free_at for l in self.lanes])
                k = 0
                while (pending and k < self.n_lanes
                       and pending[0].delta is None):
                    nxt = pending.popleft()
                    self._start(self.lanes[k], nxt, max(base, nxt.t))
                    k += 1
                continue
            idle = [l for l in self.lanes if l.run is None]
            if not idle:
                return
            # selection: FCFS takes the head; an admission policy (EDF is
            # `qos.EdfPolicy`, auto-installed for policy="edf") picks from
            # the whole segment ahead of the next write barrier (a delta
            # stays a barrier: nothing behind it is eligible)
            if self.admission is not None:
                seg = []
                for a in pending:
                    if a.delta is not None:
                        break
                    seg.append(a)
                now = max(min(l.free_at for l in idle), self._write_ts)
                item = self.admission.select(seg, now)
            lane = min(idle, key=lambda l: (max(item.t, l.free_at), l.idx))
            start_t = max(item.t, item.not_before, lane.free_at,
                          self._write_ts)
            # FCFS on the virtual clock: an in-flight lane frees no earlier
            # than its current stage boundary, so only take the idle lane
            # once no busy lane can possibly beat it — otherwise defer and
            # let the ticks sharpen the busy lanes' lower bounds. (This is
            # what keeps a 300s straggler's lane from swallowing queries
            # another lane would serve within a second.)
            # (a held lane — hedge stash — bounds at its stashed finish)
            busy_bound = min(
                (max(item.t, l.next_event if l.state is not None
                     else l.held) for l in self.lanes
                 if l.run is not None), default=np.inf)
            if start_t > busy_bound:
                return
            budget, degraded, predicted = None, False, None
            if self.admission is not None:
                dec = self.admission.admit(item, start_t)
                if dec.action == "reject":
                    pending.remove(item)
                    self.rejections.append(Rejection(
                        seq=item.seq, query=item.query, seed=item.seed,
                        tenant=item.tenant, arrival_t=item.t,
                        reject_t=start_t, deadline=item.deadline,
                        predicted=dec.predicted, reason=dec.reason))
                    if self.obs is not None:
                        self.obs.event("admission_reject",
                                       {"seq": item.seq,
                                        "tenant": item.tenant,
                                        "reason": dec.reason}, t=start_t)
                    continue
                if dec.action == "defer":
                    # rate-limited: floor the admit time and re-select —
                    # the raised not_before feeds straight into start_t,
                    # so one retry later this same arrival admits cleanly
                    item.not_before = max(item.not_before, dec.not_before)
                    continue
                budget, degraded = dec.hook_budget, dec.degraded
                predicted = dec.predicted
            pending.remove(item)
            self._start(lane, item, start_t, hook_budget=budget,
                        degraded=degraded, predicted=predicted)

    def _start(self, lane: _Lane, arrival: Arrival, admit_t: float, *,
               hook_budget: Optional[int] = None, degraded: bool = False,
               predicted: Optional[float] = None) -> None:
        q = arrival.query
        ticket = arrival.ticket
        if ticket is not None:
            # a retry/hedge re-admission: the ticket overrides the hook
            # budget (0 by default — retries run the resumed/replanned
            # remainder without competing for policy bandwidth)
            hook_budget = ticket.hook_budget
        # plan-memory fast path: probe AHEAD of the agent — on a hit the
        # run gets exactly len(actions) suspensions and `_replay` scripts
        # them, so this query never enters an act_batch. Retries keep
        # their ticket semantics (a memoized plan already failed once on
        # this band would be fenced by the completion hook anyway).
        memo = None
        if arrival.ticket is None and self.plan_memory is not None:
            memo = self.plan_memory.probe(q, self.db.versions)
            if self.obs is not None:
                self.obs.event(
                    "plan_memory_hit" if memo is not None
                    else "plan_memory_miss",
                    {"lane": lane.idx, "query": q.name}, t=admit_t)
        if memo is not None:
            steps = len(memo.actions)
        else:
            steps = self.agent.cfg.max_steps if hook_budget is None \
                else min(hook_budget, self.agent.cfg.max_steps)
        cache = None
        shared = getattr(self.db, "_stage_cache", None)
        if self.reuse_stages and isinstance(shared, PartitionedStageCache):
            cache = shared.partition(arrival.tenant)
        plan = syntactic_plan(q) if ticket is None or ticket.plan is None \
            else ticket.plan
        faults = None
        if self.recovery is not None:
            faults = self.recovery.run_faults(arrival)
            self.recovery.on_admit(arrival, admit_t)
        # the tracer opens an attempt record and returns the sink the
        # executor writes scan/join/failure notes into
        trace = None if self.obs is None \
            else self.obs.on_admit(lane, arrival, admit_t)
        run = AdaptiveRun(self.db, q, plan, self.est,
                          self.cluster, max_hook_steps=steps,
                          plan_time=0.0, reuse_stages=self.reuse_stages,
                          cache=cache, faults=faults,
                          init_mats=None if ticket is None else ticket.mats,
                          init_stages_done=0 if ticket is None
                          else ticket.stages_done, trace=trace)
        lane.run, lane.traj = run, Trajectory()
        lane.key = as_key(arrival.seed if arrival.seed is not None
                          else lane.idx)
        lane.extra_plan = 0.0
        lane.arrival, lane.admit_t = arrival, admit_t
        lane.hook_budget, lane.degraded = hook_budget, degraded
        lane.predicted = predicted
        lane.memoized = memo is not None
        lane.state = run.start()
        if memo is not None and lane.state is not None:
            self._replay(lane, memo)
        if lane.state is None:        # ran to completion with no boundary
            self._finish(lane)

    def _replay(self, lane: _Lane, entry) -> None:
        """Script a memoized entry's stored actions through the lane's run
        — the plan-memory fast path. Decisions are free on the virtual
        clock like agent decisions; the (tiny) apply cost is charged to
        hook_seconds. No states/masks are recorded (there was no policy
        evaluation — the harvester skips memoized completions), and a
        stored action that is illegal on the current state degrades to a
        noop inside `apply_action` (returns no plan change), so replays
        are robust to in-band drift."""
        space = self.agent.space
        for a in entry.actions:
            if lane.state is None:
                break
            t0 = time.perf_counter()
            a = int(a)
            new_plan, r, extra = apply_action(space, lane.state, a)
            lane.traj.actions.append(a)
            lane.traj.logps.append(0.0)    # scripted, not sampled
            lane.traj.rewards.append(r)
            lane.traj.decoded.append(space.decode(a))
            lane.extra_plan += extra
            if self.obs is not None:
                self.obs.on_decide(lane, lane.next_event,
                                   lane.traj.decoded[-1], r)
            lane.traj.hook_seconds += time.perf_counter() - t0
            lane.state = lane.run.resume(new_plan)
        while lane.state is not None:      # entry shorter than boundaries
            lane.state = lane.run.resume(None)

    # ------------------------------------------------------------ deciding
    def _decide(self, decide: List[_Lane]) -> None:
        """ONE batched policy call for `decide`, then resume each lane.
        The batch is padded to the fixed lane count so the jit cache sees
        one batch shape regardless of how many lanes are suspended."""
        agent, meta = self.agent, self.agent.meta
        B, F, d = self.n_lanes, self.agent.meta.feat_dim, self.agent.space.d
        self.decide_sizes.append(len(decide))
        feat = np.zeros((B, MAX_NODES, F), np.float32)
        left = np.zeros((B, MAX_NODES), np.int32)
        right = np.zeros((B, MAX_NODES), np.int32)
        mask = np.zeros((B, MAX_NODES), np.float32)
        amask = np.zeros((B, d), np.float32)
        amask[:, agent.space.noop_idx] = 1.0   # padded slots sample noop
        keys = np.zeros((B, 2), np.uint32)
        encs, prep_t = {}, {}
        for lane in decide:
            bi = lane.idx
            t0 = time.perf_counter()
            enc = encode_state(lane.state, meta)
            am = action_mask(agent.space, lane.state, stage=self.stage)
            feat[bi], left[bi], right[bi], mask[bi] = enc
            amask[bi] = am
            keys[bi] = lane.key
            encs[bi] = (enc, am)
            prep_t[bi] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if hasattr(agent, "act_batch"):
            acts, logps, new_keys = agent.act_batch(
                feat, left, right, mask, amask, keys, explore=self.explore)
        else:                  # value-based agents (DQN) have no batch path
            acts = np.zeros(B, np.int32)
            logps = np.zeros(B, np.float32)
            new_keys = keys
            for lane in decide:
                a, lp = agent.act(encs[lane.idx][0], encs[lane.idx][1],
                                  explore=self.explore)
                acts[lane.idx], logps[lane.idx] = a, lp
        act_share = (time.perf_counter() - t0) / max(len(decide), 1)

        for lane in decide:
            bi = lane.idx
            t0 = time.perf_counter()
            enc, am = encs[bi]
            a = int(acts[bi])
            lane.key = new_keys[bi]
            new_plan, r, extra = apply_action(agent.space, lane.state, a)
            lane.traj.states.append(enc)
            lane.traj.actions.append(a)
            lane.traj.logps.append(float(logps[bi]))
            lane.traj.masks.append(am)
            lane.traj.rewards.append(r)
            lane.traj.decoded.append(agent.space.decode(a))
            lane.extra_plan += extra
            if self.obs is not None:
                # the decision lands at the suspended stage boundary
                self.obs.on_decide(lane, lane.next_event,
                                   lane.traj.decoded[-1], r)
            lane.traj.hook_seconds += (prep_t[bi] + act_share
                                       + time.perf_counter() - t0)
            lane.state = lane.run.resume(new_plan)
            if lane.state is None:
                self._finish(lane)

    # ----------------------------------------------------------- finishing
    def _finish(self, lane: _Lane) -> None:
        res = lane.run.result
        arr = lane.arrival
        traj = finalize_trajectory(lane.traj, res, arr.query, self.est,
                                   self.agent, self.cluster, self.agent.meta,
                                   lane.extra_plan)
        # virtual completion: simulated execution seconds only — the policy
        # decision cost is a host metric (traj.hook_seconds / C_plan), kept
        # off the clock so completion times are bit-reproducible
        finish_t = lane.admit_t + res.latency
        if self.obs is not None:
            # annotate BEFORE recovery interception: a requeued/stashed
            # attempt still records its own result and finish time
            self.obs.on_run_finish(lane, res, finish_t)
        if self.recovery is not None and \
                self.recovery.on_finish(lane, traj, res, finish_t):
            return                    # requeued as a retry, or hedge-stashed
        comp = self._build_comp(arr, traj, res, lane.admit_t, finish_t,
                                lane.idx, lane.hook_budget, lane.degraded,
                                lane.predicted, memoized=lane.memoized)
        self.completions.append(comp)
        self._release(lane, finish_t)
        for cb in self.on_complete:
            cb(comp)

    def _build_comp(self, arr: Arrival, traj: Trajectory, res: RunResult,
                    admit_t: float, finish_t: float, lane_idx: int,
                    hook_budget: Optional[int], degraded: bool,
                    predicted: Optional[float], hedged: bool = False,
                    first_admit: Optional[float] = None,
                    memoized: bool = False) -> Completion:
        ticket = arr.ticket
        attempts = 1 if ticket is None else ticket.attempt
        recovered = attempts > 1 and not res.failed
        if res.failed:
            kind = res.failure_kind
        else:
            kind = ticket.kinds[0] if recovered and ticket.kinds else ""
        if first_admit is None:
            first_admit = admit_t if ticket is None else ticket.first_admit_t
        return Completion(
            seq=arr.seq, query=arr.query, seed=arr.seed, arrival_t=arr.t,
            admit_t=admit_t, finish_t=finish_t, lane=lane_idx,
            tick=self.ticks, traj=traj, result=res, tenant=arr.tenant,
            deadline=arr.deadline, hook_budget=hook_budget,
            degraded=degraded, predicted=predicted, attempts=attempts,
            recovered=recovered, hedged=hedged, failure_kind=kind,
            first_admit_t=first_admit, memoized=memoized)

    def _emit(self, comp: Completion) -> None:
        """Record a recovery-plane completion (the manager has already
        released the lanes involved) and fire the completion hooks."""
        self.completions.append(comp)
        for cb in self.on_complete:
            cb(comp)

    def _release(self, lane: _Lane, free_at: float) -> None:
        if self.obs is not None:
            # archive the lane's attempt closed at free_at — for a
            # cancelled hedge loser that is the winner's finish time
            self.obs.on_release(lane, free_at)
        lane.free_at = free_at
        lane.run = lane.state = lane.arrival = None
        lane.hook_budget, lane.degraded, lane.predicted = None, False, None
        lane.memoized = False
        lane.held = None
