"""Online SLO watchdog over a traced scheduler run.

`SloMonitor` is a scheduler `on_complete` hook that rides the original
observability plane: per completion it (a) appends a provenance record
(template, serving policy step, table-version band, exact phase split,
failure fields) and folds it into the `PlanLedger`; (b) feeds a bank of
streaming detectors (`serve.obs.anomaly`) with per-tenant windowed p99
and SLO margin, global queue depth, failure/retry rates and the stage-
cache hit rate; (c) on an anomaly, opens or extends an *incident*
(anomalies within `merge_gap` completions of each other are one
incident), snapshots the flight recorder, runs root-cause attribution
(`serve.obs.rca`) over the trailing window, and emits
`anomaly` / `incident_open` / `incident_rca` / `incident_close` events
into the tracer's event log — so the JSONL export alone is enough for
`serve.obs.report` to render the post-mortem.

Determinism and isolation. Everything the monitor consumes is virtual-
clock state; it never mutates the scheduler, so a monitor-on run with
alerts UNWIRED is completion-bit-identical to the same run without it
(pinned by tests/test_monitor.py and a tests/test_invariants.py
property test). `AlertHooks` is the opt-in actuation path: the top
hypothesis of a fresh incident can feed evidence to the `PolicyBreaker`
(immediate trip + rollback of a watched swap) and the `DriftController`
(alert-driven re-ANALYZE barrier) — once wired, the monitor is a
control plane and completions legitimately diverge.

Attach order matters: the monitor must observe completions AFTER the
tracer has assembled the query's span tree (it reads the exact phase
partition from it), so `QueryService` attaches it after `obs` and all
hooks.

Ledger keys use `band_width` to quantize table versions: band
`(table, version // band_width)` treats nearby versions as the same
data regime, which is what lets "same template, same band, older policy
step" serve as the counterfactual when blaming a swap.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.obs.anomaly import (Anomaly, CusumDetector, DetectorBank,
                                     EwmaDetector)
from repro_torch.serve.obs.explain import PHASES, phases_for
from repro_torch.serve.obs.rca import Hypothesis, attribute

__all__ = ["MonitorConfig", "PlanLedger", "Incident", "AlertHooks",
           "SloMonitor"]

_METRIC_LABELS = {"p99": "p99", "slo_margin": "SLO margin",
                  "queue_depth": "queue depth",
                  "failure_rate": "failure rate",
                  "retry_rate": "retry rate",
                  "cache_hit_rate": "cache hit rate"}

# monitor-emitted kinds, excluded from the event slice RCA joins over
_OWN_KINDS = frozenset({"anomaly", "incident_open", "incident_rca",
                        "incident_close"})


@dataclasses.dataclass
class MonitorConfig:
    window: int = 24          # rolling completions per windowed series
    min_warm: int = 6         # windowed series start after this many obs
    z: float = 4.0            # EWMA alert threshold (sigmas)
    min_n: int = 10           # detector warmup observations
    cooldown: int = 8         # observations muted after an alert
    cusum_k: float = 0.5      # CUSUM slack (sigmas per observation)
    cusum_h: float = 6.0      # CUSUM alert threshold
    merge_gap: int = 12       # completions: anomaly gap within one incident
    lookback: int = 24        # completions in the RCA anomaly window
    baseline_max: int = 96    # completions in the RCA baseline
    lead: float = 600.0       # virtual secs of event-log lead-in for RCA
    band_width: int = 1       # table-version quantum for ledger bands


class PlanLedger:
    """Plan-provenance ledger: (policy step, template, table-version band)
    -> streaming latency stats (Welford) + failure count. The RCA engine
    reads `regression` — current-step mean vs the best prior-step mean on
    the same template (preferring the same band) — as the counterfactual
    for blaming a policy swap."""

    def __init__(self, band_width: int = 1):
        self.band_width = max(int(band_width), 1)
        # key -> [n, mean, m2, fails, max]
        self._stats: Dict[Tuple, List] = {}

    @staticmethod
    def _step(step) -> int:
        return -1 if step is None else int(step)

    def observe(self, step, template: str, band: Tuple, latency: float,
                failed: bool) -> None:
        key = (self._step(step), template, band)
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = [0, 0.0, 0.0, 0, 0.0]
        st[0] += 1
        d = latency - st[1]
        st[1] += d / st[0]
        st[2] += d * (latency - st[1])
        st[3] += int(failed)
        st[4] = max(st[4], latency)

    def mean(self, step, template: str, band: Tuple) -> Optional[float]:
        st = self._stats.get((self._step(step), template, band))
        return None if st is None else st[1]

    def regression(self, step, template: str, band: Tuple,
                   min_n: int = 2) -> Optional[Dict]:
        """Ratio of this (step, template, band) mean to the best mean of
        any PRIOR step on the same template (same band preferred), or
        None when there is no counterfactual to compare against."""
        step = self._step(step)
        cur = self._stats.get((step, template, band))
        if cur is None or cur[0] < 1:
            return None
        prior = [(k[2] != band, st[1], k[0]) for k, st in self._stats.items()
                 if k[1] == template and k[0] != step and k[0] >= 0
                 and st[0] >= min_n]
        if not prior:
            return None
        off_band, best, prior_step = min(prior)
        if best <= 0.0:
            return None
        return {"ratio": round(cur[1] / best, 4), "step": step,
                "prior_step": prior_step, "cur_mean": round(cur[1], 4),
                "prior_mean": round(best, 4),
                "same_band": not off_band}

    def rows(self) -> List[Dict]:
        out = []
        for (step, tmpl, band), st in sorted(self._stats.items()):
            var = st[2] / st[0] if st[0] > 1 else 0.0
            out.append({"step": step, "template": tmpl,
                        "band": [list(b) for b in band], "n": st[0],
                        "mean": round(st[1], 4),
                        "std": round(var ** 0.5, 4), "fails": st[3],
                        "max": round(st[4], 4)})
        return out

    def __len__(self) -> int:
        return len(self._stats)

    def reset(self) -> None:
        self._stats.clear()


@dataclasses.dataclass
class Incident:
    id: int
    tenant: str               # tenant of the opening anomaly ("" = global)
    metric: str               # metric of the opening anomaly
    t_open: float
    first_idx: int            # completion index of the opening anomaly
    t_last: float = 0.0
    last_idx: int = 0
    anomalies: List[Anomaly] = dataclasses.field(default_factory=list)
    hypotheses: List[Hypothesis] = dataclasses.field(default_factory=list)
    fired: set = dataclasses.field(default_factory=set)
    closed: bool = False

    @property
    def top(self) -> Optional[Hypothesis]:
        return self.hypotheses[0] if self.hypotheses else None

    def as_dict(self) -> Dict:
        top = self.top
        return {"id": self.id, "tenant": self.tenant, "metric": self.metric,
                "t_open": round(self.t_open, 6),
                "t_last": round(self.t_last, 6),
                "n_anomalies": len(self.anomalies),
                "top_cause": top.cause if top else None,
                "summary": top.summary if top else None,
                "hypotheses": [h.as_dict() for h in self.hypotheses]}


class AlertHooks:
    """Opt-in actuation: route a fresh incident's top hypothesis to the
    recovery/drift control planes. Each sink fires at most once per
    incident; `on_incident` (any callable) always fires on open."""

    def __init__(self, *, breaker=None, drift=None,
                 on_incident: Optional[Callable] = None,
                 min_score: float = 2.0):
        self.breaker = breaker
        self.drift = drift
        self.on_incident = on_incident
        self.min_score = min_score
        self.log: List[Dict] = []

    def fire(self, incident: Incident, comp) -> None:
        if self.on_incident is not None and "cb" not in incident.fired:
            incident.fired.add("cb")
            self.on_incident(incident)
        top = incident.top
        if top is None or top.score < self.min_score:
            return
        if (self.breaker is not None and top.cause == "policy_swap"
                and "breaker" not in incident.fired):
            incident.fired.add("breaker")
            tripped = self.breaker.note_external_evidence(
                comp.seq, top.summary)
            self.log.append({"sink": "breaker", "incident": incident.id,
                             "tripped": bool(tripped)})
        if (self.drift is not None and top.cause == "stats_drift"
                and "drift" not in incident.fired):
            incident.fired.add("drift")
            tables = top.evidence.get("tables") or ()
            scheduled = self.drift.note_external_evidence(
                tables, comp.finish_t, reason=top.summary)
            self.log.append({"sink": "drift", "incident": incident.id,
                             "tables": list(scheduled)})


class SloMonitor:
    """Streaming SLO watchdog; see module docstring. `store` (a
    `learn.PolicyStore`) keys ledger records by the live serving step;
    without one every record lands on step -1 and swap attribution is
    simply never available."""

    def __init__(self, *, config: Optional[MonitorConfig] = None,
                 store=None, alerts: Optional[AlertHooks] = None):
        self.cfg = config if config is not None else MonitorConfig()
        self.store = store
        self.alerts = alerts
        self.ledger = PlanLedger(self.cfg.band_width)
        self.bank = DetectorBank(self._factories())
        self.records: List[Dict] = []
        self.incidents: List[Incident] = []
        self._open: Optional[Incident] = None
        self._next_id = 1
        self._tlat: Dict[str, deque] = {}
        self._fails: deque = deque(maxlen=self.cfg.window)
        self._retries: deque = deque(maxlen=self.cfg.window)
        self._hits: deque = deque(maxlen=self.cfg.window)
        self._last_hits = 0
        self.n_anomalies: Dict[str, int] = {}   # tenant ("" = global) -> n
        self.n_incidents: Dict[str, int] = {}
        self._sched = None
        self._tracer = None

    def _factories(self) -> Dict[str, Callable]:
        c = self.cfg
        ew = dict(z=c.z, min_n=c.min_n, cooldown=c.cooldown)
        cs = dict(k=c.cusum_k, h=c.cusum_h, min_n=c.min_n,
                  cooldown=c.cooldown)
        return {
            "p99": lambda: EwmaDetector(direction="high", **ew),
            "slo_margin": lambda: EwmaDetector(direction="low", **ew),
            "queue_depth": lambda: EwmaDetector(direction="high", **ew),
            "failure_rate": lambda: CusumDetector(
                direction="high", min_sigma=0.05, **cs),
            "retry_rate": lambda: CusumDetector(
                direction="high", min_sigma=0.05, **cs),
            "cache_hit_rate": lambda: EwmaDetector(
                direction="low", min_sigma=0.25, **ew),
        }

    # ------------------------------------------------------------- attach
    def attach(self, scheduler) -> None:
        assert scheduler.obs is not None, \
            "SloMonitor needs a traced scheduler (attach a Tracer first)"
        self._sched = scheduler
        self._tracer = scheduler.obs
        scheduler.on_complete.append(self._on_complete)

    # --------------------------------------------------------- completion
    def _record(self, comp) -> Dict:
        spans = self._tracer.query_spans(comp.seq)
        root = next((s for s in spans if s.cat == "query"), None)
        if root is None:            # tracer hasn't seen it (never expected)
            phases = {p: 0.0 for p in PHASES}
            phases["queue"] = comp.queue_wait
            phases["execute"] = comp.latency - comp.queue_wait
        else:
            kids = [s for s in spans if s.parent_id == root.span_id]
            phases = phases_for(root, kids)
        # every failure kind the query saw, including RECOVERED attempts
        # (a retried transient leaves no mark on the Completion itself)
        kinds = {comp.failure_kind}
        kinds.update(s.attrs.get("failure_kind", "") for s in spans
                     if s.cat in ("execute", "retry", "hedge")
                     and s.attrs.get("failed"))
        step = self.store.serving_step if self.store is not None else None
        tables = tuple(sorted({r.table for r in comp.query.relations}))
        versions = getattr(self._sched.db, "versions", {}) or {}
        band = tuple((t, int(versions.get(t, 0)) // self.cfg.band_width)
                     for t in tables)
        return {"seq": comp.seq, "tenant": comp.tenant,
                "template": getattr(comp.query, "name", f"q{comp.seq}"),
                "t": comp.finish_t, "arrival_t": comp.arrival_t,
                "latency": comp.latency, "failed": bool(comp.result.failed),
                "failure_kind": comp.failure_kind,
                "fail_kinds": tuple(sorted(k for k in kinds if k)),
                "attempts": comp.attempts,
                "recovered": bool(comp.recovered),
                "step": step, "band": band, "phases": phases}

    def _on_complete(self, comp) -> None:
        idx = len(self.records)
        rec = self._record(comp)
        self.records.append(rec)
        self.ledger.observe(rec["step"], rec["template"], rec["band"],
                            rec["latency"], rec["failed"])
        anomalies = self._detect(comp, rec)
        if anomalies:
            self._ingest(anomalies, comp, idx)

    def _detect(self, comp, rec: Dict) -> List[Anomaly]:
        c, t = self.cfg, comp.finish_t
        out: List[Anomaly] = []

        def obs(metric: str, value: float) -> None:
            a = self.bank.observe(metric, t, value)
            if a is not None:
                out.append(a)

        tn = comp.tenant
        lat = self._tlat.get(tn)
        if lat is None:
            lat = self._tlat[tn] = deque(maxlen=c.window)
        lat.append(rec["latency"])
        if len(lat) >= c.min_warm:
            obs(f"p99[{tn}]", float(np.percentile(np.asarray(lat), 99)))
        if comp.deadline is not None:
            obs(f"slo_margin[{tn}]", comp.deadline - comp.finish_t)
        obs("queue_depth", float(len(self._sched._pending)))
        self._fails.append(float(rec["failed"]))
        self._retries.append(float(max(rec["attempts"] - 1, 0)))
        hits = self._tracer.metrics.counter("stage_cache_hits").value
        self._hits.append(float(hits - self._last_hits))
        self._last_hits = hits
        if len(self._fails) >= c.min_warm:
            obs("failure_rate", float(np.mean(self._fails)))
            obs("retry_rate", float(np.mean(self._retries)))
            obs("cache_hit_rate", float(np.mean(self._hits)))
        return out

    # ---------------------------------------------------------- incidents
    @staticmethod
    def _tenant_of(metric: str) -> str:
        return metric.split("[", 1)[1].rstrip("]") if "[" in metric else ""

    def _bump(self, table: Dict[str, int], tenant: str) -> None:
        table[tenant] = table.get(tenant, 0) + 1

    def _ingest(self, anomalies: List[Anomaly], comp, idx: int) -> None:
        t = comp.finish_t
        inc = self._open
        if inc is None or idx - inc.last_idx > self.cfg.merge_gap:
            self._close_open(t)
            first = anomalies[0]
            inc = Incident(self._next_id, self._tenant_of(first.metric),
                           first.metric, t, idx)
            self._next_id += 1
            self.incidents.append(inc)
            self._open = inc
            self._bump(self.n_incidents, inc.tenant)
            self._tracer.event("incident_open",
                               {"id": inc.id, "tenant": inc.tenant,
                                "metric": inc.metric}, t=t)
            self._tracer.flight.snapshot(f"incident:{inc.id}", t)
        inc.last_idx, inc.t_last = idx, t
        inc.anomalies.extend(anomalies)
        for a in anomalies:
            self._bump(self.n_anomalies, self._tenant_of(a.metric))
            self._tracer.event("anomaly",
                               {"incident": inc.id, **a.as_dict()}, t=t)
        inc.hypotheses = self._rca(inc, idx, t)
        top = inc.top
        self._tracer.event("incident_rca",
                           {"incident": inc.id, "top": top.cause,
                            "score": round(top.score, 4),
                            "summary": top.summary}, t=t)
        if self.alerts is not None:
            self.alerts.fire(inc, comp)

    def _rca(self, inc: Incident, idx: int, t: float) -> List[Hypothesis]:
        c = self.cfg
        cut = max(idx + 1 - c.lookback, 0)
        window = self.records[cut:idx + 1]
        baseline = self.records[max(cut - c.baseline_max, 0):cut]
        w0 = window[0]["t"] if window else t
        events = [e for e in self._tracer.events
                  if w0 - c.lead <= e.t <= t and e.kind not in _OWN_KINDS]
        return attribute(
            tenant=inc.tenant,
            metric_label=_METRIC_LABELS.get(
                inc.metric.split("[", 1)[0], inc.metric),
            window=window, baseline=baseline, events=events,
            ledger=self.ledger)

    def _close_open(self, t: float) -> None:
        inc = self._open
        if inc is None:
            return
        inc.closed = True
        self._open = None
        self._tracer.event("incident_close", {**inc.as_dict()}, t=t)

    def finalize(self) -> None:
        """Close any open incident (QueryService calls this at run end so
        the JSONL export always carries complete incident records)."""
        last_t = self.records[-1]["t"] if self.records else 0.0
        self._close_open(last_t)

    # ------------------------------------------------------------- stats
    def tenant_counts(self, tenant: str) -> Tuple[int, int]:
        return (self.n_anomalies.get(tenant, 0),
                self.n_incidents.get(tenant, 0))

    def totals(self) -> Tuple[int, int]:
        return (sum(self.n_anomalies.values()),
                sum(self.n_incidents.values()))

    def summary(self) -> Dict:
        n_anom, n_inc = self.totals()
        return {"n_records": len(self.records),
                "n_anomalies": n_anom, "n_incidents": n_inc,
                "ledger_keys": len(self.ledger),
                "incidents": [i.as_dict() for i in self.incidents]}

    def reset(self) -> None:
        """Drop all monitor state (QueryService.reset_stats calls this;
        the tracer resets itself separately)."""
        self.bank.reset()
        self.ledger.reset()
        self.records.clear()
        self.incidents.clear()
        self._open = None
        self._next_id = 1
        self._tlat.clear()
        self._fails.clear()
        self._retries.clear()
        self._hits.clear()
        self._last_hits = 0
        self.n_anomalies.clear()
        self.n_incidents.clear()
