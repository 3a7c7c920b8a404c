"""Deterministic observability plane for the serving stack.

  trace    Tracer: per-query span trees + control-plane event log +
           flight recorder, all on the virtual clock
  metrics  MetricsRegistry: fixed-bucket counters/gauges/histograms
           sampled into a time series at virtual-clock intervals
  export   Chrome trace-event / versioned JSONL export + validator/loader
  explain  trace-diff: attribute latency deltas to phases exactly
  anomaly  streaming EWMA/CUSUM detectors (deterministic, virtual-clock)
  monitor  SloMonitor: online SLO watchdog — detectors over the live
           completion stream, plan-provenance ledger, incident lifecycle,
           opt-in alert hooks into breaker/drift control planes
  rca      root-cause attribution: event log x phase shares x ledger
           -> ranked causal hypotheses
  report   incident-report renderer: JSONL export -> markdown timeline

Attach with `QueryService(..., obs=Tracer())`; obs=None keeps every emit
point short-circuited and completions bit-identical to an untraced run.
Add `monitor=SloMonitor()` for the watchdog — monitor-on with alerts
unwired is still completion-bit-identical.
"""
from repro_torch.serve.obs.anomaly import (Anomaly, CusumDetector, DetectorBank,
                                     EwmaDetector)
from repro_torch.serve.obs.explain import diff_profiles, format_diff, run_profile
from repro_torch.serve.obs.export import (chrome_trace, load_trace_jsonl,
                                    validate_trace_jsonl,
                                    write_chrome_trace, write_trace_jsonl)
from repro_torch.serve.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.serve.obs.monitor import (AlertHooks, Incident, MonitorConfig,
                                     PlanLedger, SloMonitor)
from repro_torch.serve.obs.rca import CAUSES, Hypothesis, attribute
from repro_torch.serve.obs.report import render_incident_report
from repro_torch.serve.obs.trace import (SCHEMA_VERSION, Event, FlightRecorder,
                                   RunTrace, Span, Tracer)

__all__ = [
    "SCHEMA_VERSION", "Tracer", "Span", "Event", "RunTrace",
    "FlightRecorder", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "chrome_trace", "write_chrome_trace", "write_trace_jsonl",
    "load_trace_jsonl", "validate_trace_jsonl", "run_profile",
    "diff_profiles", "format_diff",
    "Anomaly", "EwmaDetector", "CusumDetector", "DetectorBank",
    "MonitorConfig", "PlanLedger", "Incident", "AlertHooks", "SloMonitor",
    "CAUSES", "Hypothesis", "attribute", "render_incident_report",
]
