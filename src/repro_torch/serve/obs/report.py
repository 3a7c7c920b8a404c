"""Incident-report renderer: a run's JSONL export -> markdown post-mortem.

Pure function of the export file — the monitor writes everything the
report needs (anomaly / incident_open / incident_rca / incident_close
events with ranked hypotheses in their attrs) into the tracer's event
log, so rendering needs no live objects: archive the JSONL, render the
post-mortem anywhere.

Report layout:
  # <title>
  ## Run summary        counts from the span/event/sample lines
  ## Timeline           every control-plane event + anomaly + flight
                        dump, one markdown table row each, in virtual-
                        time order
  ## Incidents          one section per incident: its anomaly list and
                        the RCA engine's ranked hypotheses
  ## Metrics            final counter values + histogram summaries

CLI:
  python -m repro_torch.serve.obs.report --render PATH [--out OUT]
  python -m repro_torch.serve.obs.report --selftest [PATH]   # CI gate: serve a
      monitored stream with a seeded queue flood, export, validate,
      check the loader round-trip, render, check the sections
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.serve.obs.export import load_trace_jsonl, validate_trace_jsonl

__all__ = ["render_incident_report", "main"]

_TIMELINE_CAP = 250


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v) if v else "-"
    return str(v)


def _detail(kind: str, attrs: Dict) -> str:
    skip = {"hypotheses"}                     # rendered in their own section
    parts = [f"{k}={_fmt_val(v)}" for k, v in attrs.items()
             if k not in skip and not isinstance(v, dict)]
    s = " ".join(parts)
    return s[:117] + "..." if len(s) > 120 else s


def _md_escape(s: str) -> str:
    return s.replace("|", "\\|")


def render_incident_report(trace: Dict, *,
                           title: str = "Incident report") -> str:
    spans = trace.get("spans", [])
    events = trace.get("events", [])
    samples = trace.get("samples", [])
    hists = trace.get("hists", [])
    dumps = trace.get("dumps", [])
    roots = [s for s in spans if s.get("cat") == "query"]
    n_failed = sum(bool(s.get("attrs", {}).get("failed")) for s in roots)
    opens = [e for e in events if e["kind"] == "incident_open"]
    closes = {e["attrs"].get("id"): e for e in events
              if e["kind"] == "incident_close"}
    anomalies = [e for e in events if e["kind"] == "anomaly"]
    makespan = max((s["t1"] for s in roots), default=0.0) - \
        min((s["t0"] for s in roots), default=0.0)

    lines: List[str] = [f"# {title}", ""]
    lines += ["## Run summary", "",
              f"- queries completed: **{len(roots)}** "
              f"({n_failed} failed), makespan {makespan:.1f}s "
              "(virtual clock)",
              f"- control-plane events: **{len(events)}**, metric "
              f"samples: {len(samples)}, flight dumps: {len(dumps)}",
              f"- anomalies: **{len(anomalies)}**, incidents: "
              f"**{len(opens)}**", ""]

    # ------------------------------------------------------------ timeline
    rows = [(e["t"], e["kind"], _detail(e["kind"], e.get("attrs", {})))
            for e in events]
    rows += [(d["t"], "flight_dump",
              f"reason={d['reason']} records={d['n']}") for d in dumps]
    rows.sort(key=lambda r: (r[0], r[1]))
    lines += ["## Timeline", ""]
    if rows:
        lines += ["| t (virtual s) | kind | detail |",
                  "|---:|---|---|"]
        for t, kind, detail in rows[:_TIMELINE_CAP]:
            lines.append(f"| {t:.3f} | {kind} | {_md_escape(detail)} |")
        if len(rows) > _TIMELINE_CAP:
            lines.append(f"| ... | ... | {len(rows) - _TIMELINE_CAP} more "
                         "rows elided |")
    else:
        lines.append("(no control-plane events recorded)")
    lines.append("")

    # ----------------------------------------------------------- incidents
    lines += ["## Incidents", ""]
    if not opens:
        lines.append("No incidents detected.")
    for op in opens:
        iid = op["attrs"].get("id")
        tenant = op["attrs"].get("tenant") or "(global)"
        close = closes.get(iid)
        info = close["attrs"] if close is not None else dict(op["attrs"])
        t0 = info.get("t_open", op["t"])
        t1 = info.get("t_last", op["t"])
        lines.append(f"### Incident {iid} — tenant {tenant}, "
                     f"t={t0:.1f}s..{t1:.1f}s")
        lines.append("")
        if info.get("summary"):
            lines.append(f"**{info['summary']}**")
            lines.append("")
        mine = [a for a in anomalies if a["attrs"].get("incident") == iid]
        if mine:
            lines.append(f"Anomalies ({len(mine)}):")
            for a in mine:
                at = a["attrs"]
                lines.append(
                    f"- t={a['t']:.1f}s `{at.get('metric')}` "
                    f"{at.get('kind')}/{at.get('direction')}: value "
                    f"{_fmt_val(at.get('value'))} vs baseline "
                    f"{_fmt_val(at.get('baseline'))} "
                    f"(score {_fmt_val(at.get('score'))})")
            lines.append("")
        hyps = info.get("hypotheses") or []
        if hyps:
            lines.append("Ranked hypotheses:")
            for i, h in enumerate(hyps, 1):
                lines.append(f"{i}. **{h['cause']}** "
                             f"(score {h['score']:.2f}) — {h['summary']}")
            lines.append("")
        if close is None:
            lines.append("(incident still open at export time)")
            lines.append("")

    # ------------------------------------------------------------- metrics
    lines += ["## Metrics", ""]
    if samples:
        last = samples[-1]
        keys = [k for k in last if k != "t"]
        lines += [f"Final sample (t={last['t']:.1f}s):", "",
                  "| metric | value |", "|---|---:|"]
        for k in sorted(keys):
            lines.append(f"| {_md_escape(k)} | {_fmt_val(last[k])} |")
        lines.append("")
    if hists:
        lines += ["| histogram | n | mean |", "|---|---:|---:|"]
        for h in hists:
            mean = h["sum"] / h["n"] if h["n"] else 0.0
            lines.append(f"| {_md_escape(h['name'])} | {h['n']} | "
                         f"{mean:.3f} |")
        lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------- selftest
def _selftest(path: str) -> int:
    """Serve a small monitored stream with a seeded queue flood, export,
    validate, round-trip the loader, render, and check the report — the
    gating CI check for the whole monitor->report pipeline."""
    from repro_torch.core.agent import AgentConfig, AqoraAgent
    from repro_torch.core.encoding import WorkloadMeta
    from repro_torch.serve.obs.monitor import MonitorConfig, SloMonitor
    from repro_torch.serve.obs.trace import Tracer
    from repro_torch.serve.obs.export import write_trace_jsonl
    from repro_torch.serve.scheduler import Arrival
    from repro_torch.serve.service import QueryService
    from repro_torch.sql import datagen
    from repro_torch.sql.workloads import make_workload

    db = datagen.make_job_like(scale=0.03, seed=0)
    wl = make_workload("job", n_train=8, n_test_per_template=1, seed=7)
    agent = AqoraAgent(WorkloadMeta.from_workload(wl),
                       AgentConfig(max_steps=2), seed=0)
    tracer = Tracer()
    monitor = SloMonitor(config=MonitorConfig(window=8, min_warm=4,
                                              min_n=6, cooldown=4))
    svc = QueryService(db, agent, n_lanes=2, obs=tracer, monitor=monitor)
    qs = [wl.train[i % len(wl.train)] for i in range(20)]
    # 12 paced arrivals warm the detectors, then an 8-query flood at one
    # instant starves the 2 lanes: queue depth + p99 must alert
    stream = [Arrival(3.0 * i if i < 12 else 36.0, query=q, seed=i)
              for i, q in enumerate(qs)]
    comps, stats = svc.run(stream)
    write_trace_jsonl(tracer, path)
    errs = validate_trace_jsonl(path)
    trace = load_trace_jsonl(path)
    roundtrip_ok = (trace["samples"] ==
                    [json.loads(json.dumps(r)) for r in tracer.metrics.series])
    md = render_incident_report(trace, title="report selftest")
    out = path + ".md"
    with open(out, "w") as f:
        f.write(md)
    checks = {
        "completions": len(comps) == len(stream),
        "export_valid": not errs,
        "loader_roundtrip": roundtrip_ok,
        "incident_detected": len(monitor.incidents) >= 1,
        "sections": all(s in md for s in
                        ("## Run summary", "## Timeline", "## Incidents",
                         "## Metrics", "### Incident")),
        "hypotheses_rendered": "Ranked hypotheses:" in md,
    }
    ok = all(checks.values())
    print(f"selftest: {len(comps)} completions, "
          f"{len(monitor.incidents)} incidents, "
          f"{sum(len(i.anomalies) for i in monitor.incidents)} anomalies "
          f"-> {path} + .md: {'OK' if ok else 'FAIL'}")
    for name, good in checks.items():
        if not good:
            print(f"  FAIL: {name}")
    for e in errs:
        print(f"  {e}")
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.serve.obs.report")
    ap.add_argument("--render", metavar="PATH",
                    help="render a trace JSONL export as markdown")
    ap.add_argument("--out", metavar="OUT",
                    help="write the rendered report here (default stdout)")
    ap.add_argument("--title", default="Incident report")
    ap.add_argument("--selftest", nargs="?",
                    const="/tmp/obs_report_selftest.jsonl", metavar="PATH",
                    help="serve a monitored stream with a seeded incident, "
                    "export, validate and render it")
    args = ap.parse_args(argv)
    if args.render:
        md = render_incident_report(load_trace_jsonl(args.render),
                                    title=args.title)
        if args.out:
            with open(args.out, "w") as f:
                f.write(md)
            print(f"wrote {args.out}")
        else:
            print(md)
        return 0
    if args.selftest:
        return _selftest(args.selftest)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
