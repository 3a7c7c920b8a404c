"""Trace export: Chrome trace-event JSON (Perfetto-loadable) and a
versioned JSONL format with a validator.

JSONL schema (one JSON object per line; `schema_version` gates readers):

  line type   required fields
  ---------   -----------------------------------------------------------
  header      type, schema_version, n_spans, n_events, n_samples, n_dumps
  span        type, id, parent, seq, name, cat, t0, t1, lane, attrs
  event       type, t, kind, attrs
  sample      type, t, ... (one column per counter/gauge)
  hist        type, name, bounds, counts, n, sum
  dump        type, reason, t, n, records   (flight-recorder snapshots)

`validate_trace_jsonl` is the CI gate: it checks the header version, the
per-line required fields, interval sanity (t1 >= t0) and span parent
references, returning a list of error strings (empty = valid).

CLI:
  python -m repro_torch.serve.obs.export --validate PATH   # gate an export
  python -m repro_torch.serve.obs.export --selftest [PATH] # tiny traced serve
                                                     # -> export -> validate
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.serve.obs.trace import SCHEMA_VERSION, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "write_trace_jsonl",
           "load_trace_jsonl", "validate_trace_jsonl", "SCHEMA_VERSION"]

_LINE_FIELDS = {
    "header": ("schema_version", "n_spans", "n_events", "n_samples",
               "n_dumps"),
    "span": ("id", "parent", "seq", "name", "cat", "t0", "t1", "lane",
             "attrs"),
    "event": ("t", "kind", "attrs"),
    "sample": ("t",),
    "hist": ("name", "bounds", "counts", "n", "sum"),
    "dump": ("reason", "t", "n", "records"),
}
_SPAN_CATS = frozenset({"query", "queue", "execute", "retry", "hedge",
                        "stage", "hook"})
# instant events / control-plane track live on a tid above any lane index
_CTRL_TID = 10_000


def chrome_trace(tracer: Tracer) -> Dict:
    """Chrome trace-event JSON (load in ui.perfetto.dev or
    chrome://tracing). Spans become complete events ("X", microsecond
    ts/dur) on tid = lane (control/queue spans on a meta track); events
    become instants ("i")."""
    ev: List[Dict] = []
    tids = set()
    for s in tracer.spans:
        tid = s.lane if s.lane >= 0 else _CTRL_TID
        tids.add(tid)
        ev.append({"name": s.name, "cat": s.cat, "ph": "X",
                   "ts": round(s.t0 * 1e6, 3),
                   "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
                   "pid": 0, "tid": tid,
                   "args": {"seq": s.seq, **s.attrs}})
    for e in tracer.events:
        tids.add(_CTRL_TID)
        ev.append({"name": e.kind, "cat": "control", "ph": "i",
                   "ts": round(e.t * 1e6, 3), "pid": 0, "tid": _CTRL_TID,
                   "s": "g", "args": dict(e.attrs)})
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
             "args": {"name": "control-plane" if t == _CTRL_TID
                      else f"lane-{t}"}} for t in sorted(tids)]
    return {"traceEvents": meta + ev,
            "displayTimeUnit": "ms",
            "otherData": {"schema_version": SCHEMA_VERSION,
                          "clock": "virtual-seconds"}}


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path


def write_trace_jsonl(tracer: Tracer, path: str) -> str:
    hists = tracer.metrics.snapshot()["histograms"]
    with open(path, "w") as f:
        f.write(json.dumps({
            "type": "header", "schema_version": SCHEMA_VERSION,
            "n_spans": len(tracer.spans), "n_events": len(tracer.events),
            "n_samples": len(tracer.metrics.series),
            "n_dumps": len(tracer.flight.dumps)}) + "\n")
        for s in tracer.spans:
            f.write(json.dumps(s.as_dict()) + "\n")
        for e in tracer.events:
            f.write(json.dumps(e.as_dict()) + "\n")
        for row in tracer.metrics.series:
            f.write(json.dumps({"type": "sample", **row}) + "\n")
        for name, h in hists.items():
            f.write(json.dumps({"type": "hist", "name": name, **h}) + "\n")
        for d in tracer.flight.dumps:
            f.write(json.dumps(d) + "\n")
    return path


def load_trace_jsonl(path: str) -> Dict:
    """Inverse of `write_trace_jsonl`: parse an export back into
    {"header", "spans", "events", "samples", "hists", "dumps"} of raw
    dicts (the "type" tag stripped). Values survive bit-exact: the writer
    rounds before serializing, so load(write(x)) == the in-memory rows —
    pinned by tests/test_obs.py."""
    out: Dict = {"header": None, "spans": [], "events": [], "samples": [],
                 "hists": [], "dumps": []}
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            obj = json.loads(raw)
            t = obj.pop("type", None)
            if t == "header":
                out["header"] = obj
            elif t in ("span", "event", "sample", "hist", "dump"):
                out[t + "s"].append(obj)
    return out


def validate_trace_jsonl(path: str) -> List[str]:
    """Validate a JSONL export; returns error strings (empty = valid)."""
    errors: List[str] = []
    header = None
    counts = {"span": 0, "event": 0, "sample": 0, "dump": 0}
    span_ids = set()
    parents: List[tuple] = []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError as e:
                errors.append(f"line {ln}: invalid JSON ({e})")
                continue
            t = obj.get("type")
            if t not in _LINE_FIELDS:
                errors.append(f"line {ln}: unknown line type {t!r}")
                continue
            missing = [k for k in _LINE_FIELDS[t] if k not in obj]
            if missing:
                errors.append(f"line {ln}: {t} missing fields {missing}")
                continue
            if ln == 1:
                if t != "header":
                    errors.append("line 1: first line must be the header")
                else:
                    header = obj
                    if obj["schema_version"] != SCHEMA_VERSION:
                        errors.append(
                            f"header: schema_version {obj['schema_version']}"
                            f" != supported {SCHEMA_VERSION}")
            elif t == "header":
                errors.append(f"line {ln}: duplicate header")
            if t == "span":
                counts["span"] += 1
                span_ids.add(obj["id"])
                parents.append((ln, obj["parent"]))
                if obj["t1"] < obj["t0"]:
                    errors.append(f"line {ln}: span t1 < t0")
                if obj["cat"] not in _SPAN_CATS:
                    errors.append(f"line {ln}: unknown span cat "
                                  f"{obj['cat']!r}")
            elif t in counts:
                counts[t] += 1
    if header is None:
        errors.append("missing header line")
    else:
        for key, n in (("n_spans", counts["span"]),
                       ("n_events", counts["event"]),
                       ("n_samples", counts["sample"]),
                       ("n_dumps", counts["dump"])):
            if header.get(key) != n:
                errors.append(f"header {key}={header.get(key)} but file "
                              f"has {n}")
    for ln, p in parents:
        if p != -1 and p not in span_ids:
            errors.append(f"line {ln}: span parent {p} not in file")
    return errors


# ---------------------------------------------------------------- selftest
def _selftest(path: str) -> int:
    """Serve a tiny traced stream, export it, validate the export — the
    gating CI trace-schema check."""
    from repro_torch.core.agent import AgentConfig, AqoraAgent
    from repro_torch.core.encoding import WorkloadMeta
    from repro_torch.serve.scheduler import Arrival
    from repro_torch.serve.service import QueryService
    from repro_torch.sql import datagen
    from repro_torch.sql.workloads import make_workload

    db = datagen.make_job_like(scale=0.03, seed=0)
    wl = make_workload("job", n_train=8, n_test_per_template=1, seed=7)
    agent = AqoraAgent(WorkloadMeta.from_workload(wl),
                       AgentConfig(max_steps=2), seed=0)
    tracer = Tracer()
    svc = QueryService(db, agent, n_lanes=2, obs=tracer)
    stream = [Arrival(0.4 * i, query=q, seed=i)
              for i, q in enumerate(wl.train[:6])]
    comps, _ = svc.run(stream)
    write_trace_jsonl(tracer, path)
    errs = validate_trace_jsonl(path)
    ok = not errs and len(comps) == len(stream) and tracer.roots()
    print(f"selftest: {len(comps)} completions, {len(tracer.spans)} spans, "
          f"{len(tracer.events)} events -> {path}: "
          f"{'OK' if ok else 'FAIL'}")
    for e in errs:
        print(f"  {e}")
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.serve.obs.export")
    ap.add_argument("--validate", metavar="PATH",
                    help="validate a trace JSONL export")
    ap.add_argument("--selftest", nargs="?", const="/tmp/obs_selftest.jsonl",
                    metavar="PATH", help="trace a tiny serve run, export "
                    "and validate it")
    args = ap.parse_args(argv)
    if args.validate:
        errs = validate_trace_jsonl(args.validate)
        for e in errs:
            print(e)
        print(f"{args.validate}: {'OK' if not errs else f'{len(errs)} errors'}")
        return 0 if not errs else 1
    if args.selftest:
        return _selftest(args.selftest)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
