"""Trace-diff explainer: attribute latency deltas between two traced runs
of the same seeded stream to phases.

Every query's latency interval [arrival, finish] is partitioned into four
phases by an interval sweep over its span tree:

  execute  time covered by the attempt that produced the Completion;
  hedge    time covered (only) by losing speculative attempts;
  retry    time covered (only) by failed earlier attempts or backoffs;
  queue    the residual — admission-queue wait and any uncovered gap.

The sweep resolves overlap by priority (execute > hedge > retry), and
queue is defined as the residual, so the four phases sum to the query's
latency EXACTLY — which makes diff attribution exact too: summing the
per-phase deltas reproduces the observed total delta to float precision,
both for the mean and for the p99 (the p99 of run X is the standard
linear-interpolated percentile of its latency vector; its phase
decomposition blends the phase vectors of the two rank-adjacent queries
with the same interpolation weight, so the blended phases still sum to
the interpolated p99).

Policy-decision host cost (`hook`) is zero-width on the virtual clock, so
it is reported as a separate count, not a phase in the sum.

Queries are aligned by `seq` — two runs of the same seeded stream share
stream positions even when completion ORDER differs (different lane
counts, recovery arms, drift policies).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.obs.trace import Span, Tracer

__all__ = ["PHASES", "phases_for", "run_profile", "percentile_profile",
           "diff_profiles", "format_diff"]

PHASES = ("queue", "execute", "retry", "hedge")
_PRIORITY = {"execute": 0, "hedge": 1, "retry": 2}   # lower wins overlap


def phases_for(root: Span, children: List[Span]) -> Dict[str, float]:
    """Partition `root`'s interval among PHASES via a boundary sweep over
    its direct attempt/backoff children. Exact: values sum to root.dur."""
    ivals: List[Tuple[float, float, int]] = []
    for s in children:
        pr = _PRIORITY.get(s.cat)
        if pr is None:
            continue
        t0, t1 = max(s.t0, root.t0), min(s.t1, root.t1)
        if t1 > t0:
            ivals.append((t0, t1, pr))
    out = {p: 0.0 for p in PHASES}
    if not ivals:
        out["queue"] = root.dur
        return out
    cuts = sorted({root.t0, root.t1}
                  | {t for iv in ivals for t in (iv[0], iv[1])})
    covered = 0.0
    by_pr = ("execute", "hedge", "retry")
    for a, b in zip(cuts, cuts[1:]):
        best: Optional[int] = None
        for t0, t1, pr in ivals:
            if t0 <= a and b <= t1 and (best is None or pr < best):
                best = pr
        if best is not None:
            out[by_pr[best]] += b - a
            covered += b - a
    # queue as the residual keeps the partition exact under float error
    out["queue"] = root.dur - (out["execute"] + out["hedge"] + out["retry"])
    return out


def run_profile(tracer: Tracer) -> Dict[int, Dict]:
    """Per-query phase profile: {seq: {total, queue, execute, retry,
    hedge, hooks, failed, name}}."""
    kids: Dict[int, List[Span]] = {}
    for s in tracer.spans:
        kids.setdefault(s.parent_id, []).append(s)
    out: Dict[int, Dict] = {}
    for root in tracer.roots():
        ch = kids.get(root.span_id, [])
        prof = phases_for(root, ch)
        prof["total"] = root.dur
        prof["hooks"] = sum(1 for s in tracer.spans
                            if s.seq == root.seq and s.cat == "hook")
        prof["failed"] = bool(root.attrs.get("failed"))
        prof["name"] = root.name
        out[root.seq] = prof
    return out


def percentile_profile(profiles: List[Dict], q: float) -> Dict[str, float]:
    """Linear-interpolated percentile of `total` with a phase decomposition
    that sums to it exactly: blend the phase vectors of the rank-adjacent
    queries (sorted by total) with the interpolation fraction."""
    assert profiles
    ordered = sorted(profiles, key=lambda p: p["total"])
    rank = (len(ordered) - 1) * (q / 100.0)
    k = int(math.floor(rank))
    f = rank - k
    lo = ordered[k]
    hi = ordered[min(k + 1, len(ordered) - 1)]
    out = {"total": lo["total"] + f * (hi["total"] - lo["total"])}
    for p in PHASES:
        out[p] = lo[p] + f * (hi[p] - lo[p])
    return out


def _mean_profile(profiles: List[Dict]) -> Dict[str, float]:
    n = max(len(profiles), 1)
    out = {"total": sum(p["total"] for p in profiles) / n}
    for ph in PHASES:
        out[ph] = sum(p[ph] for p in profiles) / n
    return out


def diff_profiles(a: Dict[int, Dict], b: Dict[int, Dict], *,
                  label_a: str = "a", label_b: str = "b",
                  q: float = 99.0, top: int = 5) -> Dict:
    """Attribute the latency delta between two aligned runs to phases.
    Returns mean and p-`q` attributions (each with per-phase deltas that
    sum exactly to the total delta) plus the top individual movers."""
    common = sorted(set(a) & set(b))
    pa = [a[s] for s in common]
    pb = [b[s] for s in common]
    assert pa, "no common seqs between the two runs"
    mean_a, mean_b = _mean_profile(pa), _mean_profile(pb)
    pq_a = percentile_profile(pa, q)
    pq_b = percentile_profile(pb, q)
    movers = sorted(
        ({"seq": s, "name": b[s]["name"],
          "delta": b[s]["total"] - a[s]["total"],
          "phases": {p: b[s][p] - a[s][p] for p in PHASES}}
         for s in common),
        key=lambda m: -abs(m["delta"]))[:top]
    return {
        "label_a": label_a, "label_b": label_b,
        "n_common": len(common),
        "n_only_a": len(set(a) - set(b)),
        "n_only_b": len(set(b) - set(a)),
        "q": q,
        "mean": {"a": mean_a["total"], "b": mean_b["total"],
                 "delta": mean_b["total"] - mean_a["total"],
                 "phases": {p: mean_b[p] - mean_a[p] for p in PHASES}},
        "pq": {"a": pq_a["total"], "b": pq_b["total"],
               "delta": pq_b["total"] - pq_a["total"],
               "phases": {p: pq_b[p] - pq_a[p] for p in PHASES}},
        "hook_decisions": {"a": sum(p["hooks"] for p in pa),
                           "b": sum(p["hooks"] for p in pb)},
        "top_movers": movers,
    }


def format_diff(diff: Dict) -> str:
    """Human-readable rendering of a `diff_profiles` result."""
    la, lb = diff["label_a"], diff["label_b"]
    lines = [f"trace diff: {la} -> {lb} "
             f"({diff['n_common']} aligned queries)"]
    for key, title in (("mean", "mean"), ("pq", f"p{diff['q']:g}")):
        d = diff[key]
        lines.append(f"  {title}: {d['a']:.3f}s -> {d['b']:.3f}s "
                     f"(delta {d['delta']:+.3f}s)")
        for p in PHASES:
            dv = d["phases"][p]
            if abs(dv) > 1e-12:
                lines.append(f"    {p:<8}{dv:+10.3f}s")
    hk = diff["hook_decisions"]
    if hk["a"] != hk["b"]:
        lines.append(f"  hook decisions: {hk['a']} -> {hk['b']} "
                     "(host-cost only; zero-width on the virtual clock)")
    if diff["top_movers"]:
        lines.append("  top movers:")
        for m in diff["top_movers"]:
            dom = max(PHASES, key=lambda p: abs(m["phases"][p]))
            lines.append(f"    {m['name']:<12}{m['delta']:+10.3f}s "
                         f"(mostly {dom})")
    return "\n".join(lines)
