"""Deterministic per-query tracing on the serving virtual clock.

One `Tracer` observes one `LaneScheduler` run through (a) the existing
`on_complete` / `on_delta` hooks and (b) narrow emit points guarded by
`if scheduler.obs is not None` in the scheduler, executor, recovery
manager, drift controller, policy store, breaker and learner. Every
timestamp is VIRTUAL time, so two runs of the same seeded stream produce
identical traces — and with `obs=None` every emit point short-circuits,
keeping completions bit-identical to an untraced scheduler (pinned by
tests/test_obs.py).

Data model
----------
  Span    one timed interval [t0, t1] in a per-query tree. Categories:
            query    root, [arrival_t, finish_t]
            queue    arrival -> first lane admission
            execute  the attempt that produced the Completion
            retry    a failed earlier attempt, or a backoff interval
            hedge    the losing side of a speculative race
            stage    a scan or join inside an attempt (cache hit/miss,
                     actual vs estimated rows)
            hook     a policy decision at a stage boundary (zero virtual
                     width — decisions are free on this clock; the host
                     cost stays in Trajectory.hook_seconds)
  Event   an instant control-plane occurrence (delta_apply, barrier_task,
          retry_scheduled, hedge_launch, policy_commit/swap/rollback,
          gate_eval, breaker_trip, refit, re_analyze, learner_update,
          admission_reject, ...), timestamped on the virtual clock.

Attempt lifecycle. The scheduler opens a live attempt record at `_start`
(`on_admit`, which also returns the `RunTrace` sink the executor writes
scan/join/failure notes into), annotates it at `_decide` / `_finish`,
and archives it at `_release` — which runs BEFORE `on_complete` fires
and before a hedge pair `_resolve`s its emit, so by assembly time every
attempt of a query is closed. `_on_complete` then builds the span tree:
stage offsets (executor `state.elapsed` seconds) are rebased onto
`admit_t` and clamped into the attempt interval — a timeout's last
charge runs past the priced attempt end, and a cancelled hedge loser is
only charged to the winner's finish.

The flight recorder is a bounded ring of the most recent span/event
records; `Tracer.dump(reason)` snapshots it (on failed completions and
breaker/rollback events automatically), so a long run keeps post-mortem
context for the last N happenings without unbounded growth.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

from repro_torch.serve.obs.metrics import (LATENCY_BOUNDS, MARGIN_BOUNDS,
                                     MetricsRegistry)

__all__ = ["SCHEMA_VERSION", "Span", "Event", "RunTrace", "FlightRecorder",
           "Tracer"]

SCHEMA_VERSION = 1

# control-plane event kinds that snapshot the flight recorder on arrival
_DUMP_KINDS = frozenset({"breaker_trip", "policy_rollback"})


@dataclasses.dataclass
class Span:
    span_id: int
    parent_id: int                 # -1 = root
    seq: int                       # query stream position (-1 = none)
    name: str
    cat: str                       # query|queue|execute|retry|hedge|stage|hook
    t0: float
    t1: float
    lane: int = -1
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> Dict:
        return {"type": "span", "id": self.span_id, "parent": self.parent_id,
                "seq": self.seq, "name": self.name, "cat": self.cat,
                "t0": round(self.t0, 9), "t1": round(self.t1, 9),
                "lane": self.lane, "attrs": self.attrs}


@dataclasses.dataclass
class Event:
    t: float
    kind: str
    attrs: Dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {"type": "event", "t": round(self.t, 9), "kind": self.kind,
                "attrs": self.attrs}


class RunTrace:
    """Per-attempt sink the executor writes into (duck-typed: the executor
    never imports the obs package). Offsets are `state.elapsed` seconds —
    the tracer rebases them onto the attempt's admit time at assembly."""

    __slots__ = ("stages", "failure")

    def __init__(self):
        self.stages: List[Dict] = []
        self.failure: Optional[Dict] = None

    def scan(self, alias: str, e0: float, e1: float, rows: int,
             hit: bool) -> None:
        self.stages.append({"name": f"scan:{alias}", "e0": e0, "e1": e1,
                            "rows": int(rows), "hit": bool(hit)})

    def stage(self, tables, method: str, e0: float, e1: float, out_rows: int,
              est_rows: Optional[float], shuffles: int, hit: bool) -> None:
        self.stages.append({
            "name": f"join:{method}:" + "+".join(sorted(tables)),
            "e0": e0, "e1": e1, "rows": int(out_rows),
            "est_rows": None if est_rows is None else float(est_rows),
            "shuffles": int(shuffles), "hit": bool(hit)})

    def fail(self, kind: str, elapsed: float) -> None:
        self.failure = {"kind": kind, "elapsed": float(elapsed)}


class FlightRecorder:
    """Bounded ring over recent span/event dicts + snapshot-on-demand."""

    def __init__(self, capacity: int = 256, max_dumps: int = 16):
        self.capacity = int(capacity)
        self.max_dumps = int(max_dumps)
        self._ring: deque = deque(maxlen=self.capacity)
        self.dumps: List[Dict] = []

    def record(self, d: Dict) -> None:
        self._ring.append(d)

    def snapshot(self, reason: str, t: float) -> Optional[Dict]:
        if len(self.dumps) >= self.max_dumps:
            return None                 # bounded post-mortem state
        dump = {"type": "dump", "reason": reason, "t": round(t, 9),
                "n": len(self._ring), "records": list(self._ring)}
        self.dumps.append(dump)
        return dump

    def reset(self) -> None:
        self._ring.clear()
        self.dumps.clear()


@dataclasses.dataclass
class _Attempt:
    """Live (then archived) record of one lane admission of one query."""
    seq: int
    attempt: int                   # 1-based; hedges reuse the primary's
    lane: int
    admit_t: float
    hedge: bool
    tenant: str
    rtrace: RunTrace
    decisions: List[Dict] = dataclasses.field(default_factory=list)
    run_finish_t: Optional[float] = None
    failed: bool = False
    kind: str = ""
    end_t: Optional[float] = None  # lane free_at (cancel-aware)


class Tracer:
    """Assembles per-query span trees + control-plane event log + metrics
    from a scheduler run. Attach via `QueryService(obs=Tracer())` or
    `tracer.attach(scheduler)` directly."""

    def __init__(self, *, metrics: Optional[MetricsRegistry] = None,
                 flight_capacity: int = 256):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.flight = FlightRecorder(flight_capacity)
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.now = 0.0                 # high-water virtual time
        self._sched = None
        self._next_id = 0
        self._live: Dict[int, _Attempt] = {}      # lane idx -> open attempt
        self._closed: Dict[int, List[_Attempt]] = {}   # seq -> archived
        self._backoffs: Dict[int, List[Dict]] = {}     # seq -> retry waits
        self._by_seq: Dict[int, List[Span]] = {}       # seq -> its spans

    # -------------------------------------------------------------- attach
    def attach(self, scheduler) -> None:
        self._sched = scheduler
        scheduler.obs = self
        scheduler.on_complete.append(self._on_complete)
        scheduler.on_delta.append(self._on_delta)
        m = self.metrics
        m.gauge("lanes_busy",
                fn=lambda s=scheduler: sum(l.run is not None
                                           for l in s.lanes))
        m.gauge("queue_depth", fn=lambda s=scheduler: len(s._pending))
        m.gauge("cache_bytes",
                fn=lambda s=scheduler: float(getattr(
                    getattr(s.db, "_stage_cache", None), "bytes", 0) or 0))
        # give the policy store (if any hook installs one later) a path
        # back to this tracer: PolicyStore reads scheduler.obs lazily.

    # ---------------------------------------------------------- virtual now
    def _advance(self, t: float) -> None:
        if t > self.now:
            self.now = t
        self.metrics.advance(self.now)

    # --------------------------------------------------- scheduler emit API
    def on_admit(self, lane, arrival, admit_t: float) -> RunTrace:
        """A lane admission starts an attempt; returns the executor sink."""
        ticket = arrival.ticket
        att = 1 if ticket is None else ticket.attempt
        hedge = bool(ticket is not None and getattr(ticket, "hedge", False))
        rt = RunTrace()
        self._live[lane.idx] = _Attempt(
            seq=arrival.seq, attempt=att, lane=lane.idx, admit_t=admit_t,
            hedge=hedge, tenant=arrival.tenant, rtrace=rt)
        self.metrics.counter("attempts").inc()
        if hedge:
            self.metrics.counter("hedges").inc()
        self._advance(admit_t)
        return rt

    def on_decide(self, lane, t: float, decoded: str, reward: float) -> None:
        a = self._live.get(lane.idx)
        if a is not None:
            a.decisions.append({"t": t, "action": str(decoded),
                                "reward": float(reward)})
        self._advance(t)

    def on_run_finish(self, lane, res, finish_t: float) -> None:
        """The run produced its RunResult (BEFORE recovery interception)."""
        a = self._live.get(lane.idx)
        if a is not None:
            a.run_finish_t = finish_t
            a.failed = bool(res.failed)
            a.kind = res.failure_kind
        self._advance(finish_t)

    def on_release(self, lane, free_at: float) -> None:
        """The lane frees: archive its attempt, closed at `free_at` (for a
        cancelled hedge loser that is the winner's finish, not its own)."""
        a = self._live.pop(lane.idx, None)
        if a is None:
            return
        a.end_t = free_at
        self._closed.setdefault(a.seq, []).append(a)
        self._advance(free_at)

    def on_retry(self, seq: int, attempt: int, mode: str, kind: str,
                 t_fail: float, delay: float) -> None:
        self._backoffs.setdefault(seq, []).append(
            {"t0": t_fail, "t1": t_fail + delay, "mode": mode, "kind": kind,
             "attempt": attempt})
        self.event("retry_scheduled", {"seq": seq, "attempt": attempt,
                                       "mode": mode, "kind": kind,
                                       "delay": round(delay, 6)}, t=t_fail)
        self.metrics.counter("retries").inc()

    def on_hedge_launch(self, seq: int, attempt: int, primary_lane: int,
                        hedge_lane: int, t: float) -> None:
        self.event("hedge_launch", {"seq": seq, "attempt": attempt,
                                    "primary_lane": primary_lane,
                                    "hedge_lane": hedge_lane}, t=t)

    def on_tick(self, t: float) -> None:
        self._advance(t)

    def event(self, kind: str, attrs: Optional[Dict] = None,
              t: Optional[float] = None) -> None:
        """Generic control-plane event (drift/policy/breaker/learner emit
        points call this through `scheduler.obs` / `store.obs`)."""
        ts = self.now if t is None else float(t)
        ev = Event(ts, kind, dict(attrs or {}))
        self.events.append(ev)
        self.flight.record(ev.as_dict())
        self.metrics.counter(f"events[{kind}]").inc()
        self._advance(ts)
        if kind in _DUMP_KINDS:
            self.flight.snapshot(kind, ts)

    # ------------------------------------------------------------ assembly
    def _sid(self) -> int:
        self._next_id += 1
        return self._next_id

    def _add(self, span: Span) -> Span:
        self.spans.append(span)
        self._by_seq.setdefault(span.seq, []).append(span)
        self.flight.record(span.as_dict())
        return span

    def _on_complete(self, comp) -> None:
        attempts = self._closed.pop(comp.seq, [])
        backoffs = self._backoffs.pop(comp.seq, [])
        root = self._add(Span(
            self._sid(), -1, comp.seq, f"q{comp.seq}", "query",
            comp.arrival_t, comp.finish_t, lane=comp.lane, attrs={
                "tenant": comp.tenant, "attempts": comp.attempts,
                "failed": bool(comp.result.failed),
                "failure_kind": comp.failure_kind,
                "recovered": bool(comp.recovered),
                "hedged": bool(comp.hedged),
                "degraded": bool(comp.degraded),
                "queue_wait": round(comp.queue_wait, 9)}))
        first_admit = min([a.admit_t for a in attempts],
                          default=comp.admit_t)
        if first_admit > comp.arrival_t:
            self._add(Span(self._sid(), root.span_id, comp.seq, "queue",
                           "queue", comp.arrival_t, first_admit))
        # the attempt that produced the Completion is the execute span;
        # other hedge-flagged attempts are `hedge`, everything else `retry`
        n_real = 0
        for a in sorted(attempts, key=lambda x: (x.admit_t, x.lane)):
            if not a.hedge:
                n_real += 1
            final = (a.admit_t == comp.admit_t and a.lane == comp.lane)
            cat = "execute" if final else ("hedge" if a.hedge else "retry")
            end = a.end_t if a.end_t is not None else a.admit_t
            cancelled = (a.run_finish_t is not None and end < a.run_finish_t)
            sp = self._add(Span(
                self._sid(), root.span_id, comp.seq,
                f"attempt-{a.attempt}" + ("h" if a.hedge else ""), cat,
                a.admit_t, end, lane=a.lane, attrs={
                    "attempt": a.attempt, "hedge": a.hedge,
                    "failed": a.failed, "failure_kind": a.kind,
                    "cancelled": cancelled}))
            for st in a.rtrace.stages:
                # rebase executor elapsed-offsets onto the admit time and
                # clamp into the attempt: a timeout's final charge runs
                # past the priced end, a cancelled loser past its free_at
                t0 = min(max(a.admit_t + st["e0"], sp.t0), sp.t1)
                t1 = min(max(a.admit_t + st["e1"], sp.t0), sp.t1)
                attrs = {k: v for k, v in st.items()
                         if k not in ("name", "e0", "e1")}
                self._add(Span(self._sid(), sp.span_id, comp.seq,
                               st["name"], "stage", t0, t1, lane=a.lane,
                               attrs=attrs))
                if st.get("hit"):
                    self.metrics.counter("stage_cache_hits").inc()
            for dec in a.decisions:
                td = min(max(dec["t"], sp.t0), sp.t1)
                self._add(Span(self._sid(), sp.span_id, comp.seq, "hook",
                               "hook", td, td, lane=a.lane,
                               attrs={"action": dec["action"],
                                      "reward": round(dec["reward"], 6)}))
            if a.rtrace.failure is not None:
                sp.attrs["fail_elapsed"] = round(
                    a.rtrace.failure["elapsed"], 9)
        for b in backoffs:
            self._add(Span(self._sid(), root.span_id, comp.seq,
                           f"backoff-{b['attempt']}", "retry",
                           b["t0"], min(b["t1"], comp.finish_t),
                           attrs={"mode": b["mode"], "kind": b["kind"]}))
        # ---- metrics
        m = self.metrics
        m.counter("completions").inc()
        if comp.result.failed:
            m.counter("failures").inc()
            m.counter(f"failures[{comp.failure_kind or 'unknown'}]").inc()
        if comp.recovered:
            m.counter("recovered").inc()
        if comp.hedged:
            m.counter("hedged").inc()
        m.histogram("latency", LATENCY_BOUNDS).observe(comp.latency)
        m.histogram("queue_wait", LATENCY_BOUNDS).observe(comp.queue_wait)
        if comp.deadline is not None:
            m.histogram(f"slo_margin[{comp.tenant}]", MARGIN_BOUNDS) \
                .observe(comp.deadline - comp.finish_t)
            if comp.slo_miss:
                m.counter("slo_misses").inc()
        if n_real and n_real != comp.attempts:
            # never expected; surfaced as an event so tests can assert on it
            self.event("attempt_mismatch",
                       {"seq": comp.seq, "archived": n_real,
                        "attempts": comp.attempts}, t=comp.finish_t)
        self._advance(comp.finish_t)
        if comp.result.failed:
            self.flight.snapshot(
                f"query_failed:{comp.failure_kind or 'unknown'}",
                comp.finish_t)

    def _on_delta(self, t_apply: float, batch) -> None:
        self.event("delta_apply",
                   {"n_events": len(getattr(batch, "events", []) or [])},
                   t=t_apply)

    # ------------------------------------------------------------- queries
    def query_spans(self, seq: int) -> List[Span]:
        # indexed: the monitor reads every completion's span tree inline
        return list(self._by_seq.get(seq, ()))

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.cat == "query"]

    def children(self, span_id: int) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def reset(self) -> None:
        """Drop all recorded state (QueryService.reset_stats calls this)."""
        self.spans.clear()
        self.events.clear()
        self._live.clear()
        self._closed.clear()
        self._backoffs.clear()
        self._by_seq.clear()
        self.flight.reset()
        self.metrics.reset()
        self.now = 0.0
        self._next_id = 0
