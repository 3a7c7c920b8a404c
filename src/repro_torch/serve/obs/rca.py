"""Root-cause attribution for anomaly windows.

Given an anomaly window over the completion stream, `attribute` joins
three deterministic evidence sources into ranked causal hypotheses:

  1. the control-plane EVENT LOG (policy commits/swaps, delta barriers,
     re-ANALYZEs, retry/hedge scheduling, barrier maintenance) sliced to
     the window plus a lead-in — events GATE causes: no swap event means
     "policy_swap" scores zero, however suggestive the latency shape;
  2. the PHASE SHARES of the explainer's exact queue/execute/retry/hedge
     partition — window-vs-baseline share deltas say WHERE the latency
     went (queue-dominant regressions point at load, execute-dominant at
     planning, retry-dominant at faults);
  3. the per-template PLAN-PROVENANCE LEDGER (policy version x template
     x table-version band -> latency stats): a template whose mean under
     the serving step is a multiple of its mean under a prior step on
     the same data band is direct evidence against the swap, and a
     window whose records sit on a different band than their baseline
     modal band is direct evidence of drift.

Causes are kept SEPARABLE by their gates: a drift window with no swap
cannot blame the policy, a quiet event log leaves only load-shaped
causes (hot_tenant) and the `unknown` floor. Scores are heuristic but
deterministic and dimensionless (roughly 0-8); callers rank by score
and read `summary` / `evidence` for the human-facing claim, e.g.
"tenant B p99 regression caused by policy swap v12 on template q7".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.serve.obs.explain import PHASES

__all__ = ["Hypothesis", "attribute", "CAUSES"]

CAUSES = ("policy_swap", "stats_drift", "fault_burst", "hot_tenant",
          "maintenance", "stale_memo", "unknown")

_SWAP_KINDS = frozenset({"policy_swap", "policy_commit"})
_INJECTED_KINDS = frozenset({"crash", "transient", "slow"})
_PRESSURE_KINDS = frozenset({"oom", "timeout"})


@dataclasses.dataclass
class Hypothesis:
    cause: str
    score: float
    summary: str
    evidence: Dict

    def as_dict(self) -> Dict:
        return {"cause": self.cause, "score": round(self.score, 4),
                "summary": self.summary, "evidence": self.evidence}


def _phase_shares(records: Sequence[Dict]) -> Dict[str, float]:
    tot = sum(r["latency"] for r in records)
    if tot <= 0.0:
        return {p: 0.0 for p in PHASES}
    return {p: sum(r["phases"][p] for r in records) / tot for p in PHASES}


def _share_deltas(window: Sequence[Dict],
                  baseline: Sequence[Dict]) -> Dict[str, float]:
    """Positive part of the window-vs-baseline phase-share shift."""
    win = _phase_shares(window)
    base = _phase_shares(baseline) if baseline else {p: 0.0 for p in PHASES}
    return {p: max(win[p] - base[p], 0.0) for p in PHASES}


def _modal_bands(baseline: Sequence[Dict]) -> Dict[str, tuple]:
    counts: Dict[str, Dict[tuple, int]] = {}
    for r in baseline:
        by = counts.setdefault(r["template"], {})
        by[r["band"]] = by.get(r["band"], 0) + 1
    return {tmpl: max(by.items(), key=lambda kv: (kv[1], kv[0]))[0]
            for tmpl, by in counts.items()}


def _tenant_rates(records: Sequence[Dict]) -> Dict[str, float]:
    if not records:
        return {}
    ts = [r["arrival_t"] for r in records]
    dt = max(max(ts) - min(ts), 1e-9)
    out: Dict[str, float] = {}
    for r in records:
        out[r["tenant"]] = out.get(r["tenant"], 0.0) + 1.0
    return {tn: n / dt for tn, n in out.items()}


def _worst_regression(window: Sequence[Dict], ledger) -> Optional[Dict]:
    """Largest serving-step-vs-prior-step ledger latency ratio over the
    window's (step, template, band) triples."""
    if ledger is None:
        return None
    worst = None
    for key in sorted({(r["step"], r["template"], r["band"])
                       for r in window}):
        step, tmpl, band = key
        reg = ledger.regression(step, tmpl, band)
        if reg is None:
            continue
        if worst is None or reg["ratio"] > worst["ratio"]:
            worst = {"template": tmpl, "band": band, **reg}
    return worst


def attribute(*, tenant: str, metric_label: str,
              window: Sequence[Dict], baseline: Sequence[Dict],
              events: Sequence, ledger=None) -> List[Hypothesis]:
    """Rank causal hypotheses for one anomaly window.

    `window` / `baseline` are the monitor's per-completion records (dicts
    with template/band/step/phases/failure fields); `events` is the
    control-plane event slice covering the window plus its lead-in.
    Always returns at least the `unknown` floor hypothesis."""
    n_win = max(len(window), 1)
    who = f"tenant {tenant}" if tenant else "service"
    shares = _share_deltas(window, baseline)
    exec_share, queue_share = shares["execute"], shares["queue"]
    retry_share = shares["retry"] + shares["hedge"]
    by_kind: Dict[str, List] = {}
    for e in events:
        by_kind.setdefault(e.kind, []).append(e)
    out: List[Hypothesis] = []

    # ---- policy swap: gated on a swap/commit event in the lead-in
    swaps = sorted((e for k in _SWAP_KINDS for e in by_kind.get(k, [])),
                   key=lambda e: e.t)
    if swaps:
        last = swaps[-1]
        step = last.attrs.get("to_step", last.attrs.get("step"))
        reg = _worst_regression(window, ledger)
        reg_score = 0.0
        on_tmpl = ""
        if reg is not None:
            reg_score = min(max(math.log2(max(reg["ratio"], 1.0)), 0.0),
                            3.0) / 3.0
            on_tmpl = f" on template {reg['template']}"
        out.append(Hypothesis(
            "policy_swap",
            2.0 + 3.0 * reg_score + 2.0 * exec_share,
            f"{who} {metric_label} regression caused by policy swap "
            f"v{step}{on_tmpl}",
            {"step": step, "t_swap": round(last.t, 6),
             "ledger_regression": reg,
             "execute_share_delta": round(exec_share, 4)}))

    # ---- stats drift: gated on a delta barrier in the lead-in
    deltas = by_kind.get("delta_apply", [])
    if deltas:
        modal = _modal_bands(baseline)
        shifted_tables: List[str] = []
        n_shifted = 0
        for r in window:
            base_band = modal.get(r["template"])
            if base_band is None or r["band"] == base_band:
                continue
            n_shifted += 1
            before = dict(base_band)
            shifted_tables.extend(t for t, b in r["band"]
                                  if before.get(t) != b)
        band_shift = n_shifted / n_win
        oom_frac = sum(r["failed"] and r["failure_kind"] in _PRESSURE_KINDS
                       for r in window) / n_win
        tables = sorted(set(shifted_tables))
        out.append(Hypothesis(
            "stats_drift",
            1.5 + 1.5 * band_shift + 2.0 * oom_frac + 1.5 * exec_share,
            f"{who} {metric_label} regression caused by data drift on "
            f"{','.join(tables) if tables else 'recently-written tables'} "
            f"(stale stats after delta at t={deltas[-1].t:.0f}s)",
            {"t_delta": round(deltas[-1].t, 6), "tables": tables,
             "band_shift": round(band_shift, 4),
             "oom_frac": round(oom_frac, 4),
             "execute_share_delta": round(exec_share, 4)}))

    # ---- fault burst: gated on injected failure kinds / retry traffic
    # (fail_kinds covers RECOVERED attempts, so a burst the retry ladder
    # absorbs is still attributable)
    injected = sum(any(k in _INJECTED_KINDS for k in r["fail_kinds"])
                   for r in window)
    n_retry_ev = len(by_kind.get("retry_scheduled", []))
    if injected or n_retry_ev:
        kinds = sorted({k for r in window for k in r["fail_kinds"]
                        if k in _INJECTED_KINDS})
        out.append(Hypothesis(
            "fault_burst",
            4.0 * injected / n_win + 1.5 * min(n_retry_ev / n_win, 1.0)
            + 1.0 * retry_share,
            f"{who} {metric_label} regression caused by a fault burst "
            f"({','.join(kinds) if kinds else 'retried transients'})",
            {"injected_frac": round(injected / n_win, 4),
             "retry_events": n_retry_ev, "kinds": kinds,
             "retry_share_delta": round(retry_share, 4)}))

    # ---- hot tenant: arrival-rate blowup + queue-dominant shape
    win_rates = _tenant_rates(window)
    base_rates = _tenant_rates(baseline)
    hot, hot_ratio = "", 0.0
    for tn in sorted(win_rates):
        base = base_rates.get(tn)
        if base is None or base <= 0.0:
            continue
        ratio = win_rates[tn] / base
        if ratio > hot_ratio:
            hot, hot_ratio = tn, ratio
    if hot_ratio > 1.5 and queue_share > 0.15:
        out.append(Hypothesis(
            "hot_tenant",
            2.0 * min(math.log2(hot_ratio) / 3.0, 1.5)
            + 3.0 * queue_share,
            f"{who} {metric_label} regression caused by hot tenant "
            f"{hot} flood (arrival rate x{hot_ratio:.1f})",
            {"hot_tenant": hot, "rate_ratio": round(hot_ratio, 3),
             "queue_share_delta": round(queue_share, 4)}))

    # ---- maintenance: a charged barrier window stalls admissions
    charged = [e for e in by_kind.get("barrier_task", [])
               if e.attrs.get("charge_s", 0) > 0]
    charged += by_kind.get("re_analyze", [])
    if charged and queue_share > 0.0:
        out.append(Hypothesis(
            "maintenance",
            0.5 + 1.0 * queue_share,
            f"{who} {metric_label} regression caused by a maintenance "
            f"barrier (re-ANALYZE / barrier task at "
            f"t={charged[-1].t:.0f}s)",
            {"n_tasks": len(charged),
             "queue_share_delta": round(queue_share, 4)}))

    # ---- stale memo: gated on plan-memory fence events in the window —
    # memoized replays whose band went stale (delta / re-ANALYZE / replay
    # failure) served degraded plans until the fence landed. Execute-
    # dominant shape (the replayed plan, not queueing, burned the time).
    fences = by_kind.get("plan_memory_fenced", [])
    if fences:
        reasons = sorted({e.attrs.get("reason", "") for e in fences})
        out.append(Hypothesis(
            "stale_memo",
            1.0 + 2.0 * exec_share + 1.0 * min(len(fences) / n_win, 1.0),
            f"{who} {metric_label} regression caused by stale memoized "
            f"plans (plan memory fenced {len(fences)} entr"
            f"{'y' if len(fences) == 1 else 'ies'}: "
            f"{','.join(r for r in reasons if r)})",
            {"n_fenced": len(fences), "reasons": reasons,
             "t_last_fence": round(fences[-1].t, 6),
             "execute_share_delta": round(exec_share, 4)}))

    out.append(Hypothesis(
        "unknown", 0.3,
        f"{who} {metric_label} regression: no attributable control-plane "
        f"cause in the window",
        {"phase_share_deltas": {p: round(shares[p], 4) for p in PHASES}}))
    out.sort(key=lambda h: (-h.score, h.cause))
    return out
