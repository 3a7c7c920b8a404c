"""The port's observability plane (serve/obs) against the reference's, on
the CPU.

The scenarios of tests/test_obs.py and tests/test_monitor.py, run through
both packages on the same inputs with the same weights (the port's
seeded agent draws the reference's, leaf for leaf): tracing off is
bit-identical to tracing on; traces are deterministic and the port's
JSONL export equals the reference's line for line; export round trips
and validation; the explainer's exact phase attribution; the SLO
watchdog's drift-outage scenario with the same incidents and top-1
causes; `monitor=` without `obs=` creating its own `Tracer`; the wired
alert path healing the outage. Completions are identical (`comp_key`)
and log-probabilities agree within 1e-4.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenarios import FixedPredictor, fast_query, trap_query  # noqa: E402
from torch_scenarios import (P, PKGS, both,  # noqa: E402
                             cold_agent, comp_key, job_workload,
                             max_logp_diff, meta_for, of)

LOGP_ATOL = 1e-4


@pytest.fixture(scope="module")
def agents(agent):
    """The reference's cold serving agent (conftest) and the port's."""
    return {"repro": agent,
            "repro_torch": cold_agent("repro_torch",
                                      job_workload("repro_torch"))}


def chaos_recovery(pkg, seed):
    R = P(pkg, "serve.recover")
    return R.RecoveryManager(
        injector=R.FaultInjector(seed=seed, p_crash=0.05, p_transient=0.25,
                                 p_slow=0.2, p_corrupt=0.1),
        retry=R.RetryPolicy(max_attempts=3, backoff=0.2),
        hedge=R.HedgePolicy(factor=4.0, predictor=FixedPredictor()))


def chaos_stream(rng, n_queries=10):
    """tests/test_obs.py's chaos stream, in the reference's classes."""
    from repro.serve.deltas import DeltaBatch
    from repro.serve.scheduler import Arrival
    t, out = 0.0, []
    for i in range(n_queries):
        t += 0.05 + float(rng.exponential(0.4))
        out.append(Arrival(t, query=fast_query(int(rng.integers(6))),
                           seed=int(rng.integers(2 ** 31)),
                           deadline=t + 20.0))
        if i == n_queries // 2:
            out.append(Arrival(t, delta=DeltaBatch(
                "movie_info", n_append=400, seed=5)))
    return out


def chaos_serve(pkg, agent, seed, *, obs=None, n_lanes=3):
    db = P(pkg, "sql.datagen").make_job_like(scale=0.05, seed=0)
    svc = P(pkg, "serve.service").QueryService(
        db, agent, est=P(pkg, "sql.cbo").Estimator(db, db.stats),
        n_lanes=n_lanes, recovery=chaos_recovery(pkg, 900 + seed), obs=obs)
    comps, stats = svc.run(of(pkg, chaos_stream(
        np.random.default_rng(40 + seed))))
    return comps, stats, svc


def tracer(pkg):
    return P(pkg, "serve.obs").Tracer()


# -------------------------------------------------------------- off == on
@pytest.mark.parametrize("seed", [0, 1])
def test_obs_off_bit_identical_and_equal_to_reference(agents, seed):
    runs = {}
    for pkg in PKGS:
        off, _, _ = chaos_serve(pkg, agents[pkg], seed)
        on, _, _ = chaos_serve(pkg, agents[pkg], seed, obs=tracer(pkg))
        assert [comp_key(c) for c in off] == [comp_key(c) for c in on]
        assert all(np.array_equal(a.traj.logps, b.traj.logps)
                   for a, b in zip(off, on))
        runs[pkg] = on
    assert [comp_key(c) for c in runs["repro_torch"]] == \
        [comp_key(c) for c in runs["repro"]]
    assert max_logp_diff(runs["repro_torch"], runs["repro"]) <= LOGP_ATOL


def jsonl_records(pkg, agent, seed, path):
    t = tracer(pkg)
    chaos_serve(pkg, agent, seed, obs=t)
    P(pkg, "serve.obs.export").write_trace_jsonl(t, str(path))
    return [json.loads(line) for line in open(path)], t


def test_traces_deterministic_and_jsonl_equal_to_reference(agents,
                                                           tmp_path):
    """Two port tracers over one seeded stream dump identical spans,
    events and metrics; the port's JSONL equals the reference's record
    for record (every field is virtual-clock or a count)."""
    port, t1 = jsonl_records("repro_torch", agents["repro_torch"], 3,
                             tmp_path / "a.jsonl")
    again, t2 = jsonl_records("repro_torch", agents["repro_torch"], 3,
                              tmp_path / "b.jsonl")
    ref, _ = jsonl_records("repro", agents["repro"], 3, tmp_path / "r.jsonl")
    assert port == again
    assert [s.as_dict() for s in t1.spans] == [s.as_dict() for s in t2.spans]
    assert t1.metrics.snapshot() == t2.metrics.snapshot()
    assert len(port) == len(ref) > 1
    assert port == ref


# ----------------------------------------------------------------- export
def test_export_round_trip_and_validation(agents, tmp_path):
    E = P("repro_torch", "serve.obs.export")
    t = tracer("repro_torch")
    chaos_serve("repro_torch", agents["repro_torch"], 5, obs=t)
    path = str(tmp_path / "trace.jsonl")
    E.write_trace_jsonl(t, path)
    assert E.validate_trace_jsonl(path) == []
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:-1]))           # drop one record
    assert E.validate_trace_jsonl(path)
    bad = json.loads(lines[1])
    assert bad["type"] == "span"
    bad["cat"] = "nonsense"
    with open(path, "w") as f:
        f.write("\n".join([lines[0], json.dumps(bad)] + lines[2:]))
    assert any("cat" in e for e in E.validate_trace_jsonl(path))
    evs = E.chrome_trace(t)["traceEvents"]
    assert sum(e["ph"] == "X" for e in evs) == len(t.spans)
    assert sum(e["ph"] == "i" for e in evs) == len(t.events)

    with open(path, "w") as f:
        f.write("\n".join(lines))
    loaded = E.load_trace_jsonl(path)
    assert loaded["samples"] == t.metrics.series         # bit-exact floats
    norm = lambda rows: json.loads(json.dumps(rows))     # noqa: E731
    strip = lambda d: {k: v for k, v in d.items() if k != "type"}  # noqa
    assert loaded["spans"] == norm([strip(s.as_dict()) for s in t.spans])
    assert loaded["events"] == norm([strip(e.as_dict()) for e in t.events])


# -------------------------------------------------------------- explainer
def explain(pkg, agent):
    X = P(pkg, "serve.obs.explain")
    t1, t3 = tracer(pkg), tracer(pkg)
    c1, _, _ = chaos_serve(pkg, agent, 7, obs=t1, n_lanes=1)
    c3, _, _ = chaos_serve(pkg, agent, 7, obs=t3, n_lanes=3)
    for t, comps in ((t1, c1), (t3, c3)):
        prof = X.run_profile(t)
        assert set(prof) == {c.seq for c in comps}
        for c in comps:
            p = prof[c.seq]
            assert p["total"] == pytest.approx(c.latency, abs=1e-12)
            assert sum(p[ph] for ph in X.PHASES) == \
                pytest.approx(p["total"], abs=1e-9)
    diff = X.diff_profiles(X.run_profile(t1), X.run_profile(t3),
                           label_a="1lane", label_b="3lanes", q=99.0)
    for key in ("mean", "pq"):
        assert sum(diff[key]["phases"].values()) == \
            pytest.approx(diff[key]["delta"], abs=1e-9)
    return diff


def test_explainer_attribution_exact_and_equal_to_reference(agents):
    """Phases partition each latency exactly on the port, and its
    1-lane vs 3-lane diff is the reference's."""
    ref, port = [explain(pkg, agents[pkg]) for pkg in PKGS]
    assert port == ref
    assert port["mean"]["delta"] <= 1e-9


def test_phases_and_metrics_registry_match_reference():
    def run(pkg):
        Span = P(pkg, "serve.obs.trace").Span
        root = Span(1, -1, 0, "q0", "query", 0.0, 10.0)
        kids = [Span(2, 1, 0, "attempt-1", "execute", 4.0, 10.0),
                Span(3, 1, 0, "attempt-1h", "hedge", 2.0, 6.0),
                Span(4, 1, 0, "backoff-1", "retry", 1.0, 3.0)]
        phases = P(pkg, "serve.obs.explain").phases_for
        m = P(pkg, "serve.obs").MetricsRegistry(interval=5.0)
        state = {"v": 1.0}
        m.gauge("g", fn=lambda: state["v"])
        m.counter("c").inc(2)
        for t in (1.0, 6.0, 23.0):
            m.advance(t)
            state["v"] += 1.0
        h = m.histogram("lat", (1.0, 10.0))
        for v in (1.0, 50.0, 3.0):
            h.observe(v)
        return phases(root, []), phases(root, kids), m.series, m.snapshot()
    ref, port = both(run)
    assert port == ref
    assert port[1] == {"queue": 1.0, "execute": 6.0, "hedge": 2.0,
                       "retry": 1.0}


def service_stats(pkg, agent):
    from scenarios import qos_stream
    Q = P(pkg, "serve.qos")
    db = P(pkg, "sql.datagen").make_job_like(scale=0.05, seed=0)
    reg = Q.TenantRegistry([
        Q.TenantSpec("gold", weight=2.0, slo=40.0, cache_bytes=8 << 20),
        Q.TenantSpec("bulk", weight=1.0, rate=1.5, burst=2, slo=300.0)])
    adm = Q.QoSAdmission(reg, predictor=FixedPredictor(),
                         ladder=Q.DegradationLadder())
    mon = P(pkg, "serve.obs").SloMonitor(
        config=P(pkg, "serve.obs").MonitorConfig(
            window=6, min_warm=3, min_n=4, cooldown=3, merge_gap=6,
            lookback=8))
    svc = P(pkg, "serve.service").QueryService(
        db, agent, est=P(pkg, "sql.cbo").Estimator(db, db.stats), n_lanes=2,
        policy="edf", tenants=reg, admission=adm, monitor=mon)
    _, stats = svc.run(of(pkg, qos_stream(job_workload("repro"))))
    d = stats.as_dict()
    d.pop("hook_seconds")                       # host wall time
    return d, mon.summary()


def test_service_stats_and_watchdog_counters_match_reference(agents):
    ref, port = [service_stats(pkg, agents[pkg]) for pkg in PKGS]
    assert port == ref
    d, summary = port
    assert d == json.loads(json.dumps(d))
    assert set(d["per_tenant"]) == {"gold", "bulk"}
    assert d["n_incidents"] == summary["n_incidents"]


# ----------------------------------------- served outage: detect + attribute
GROWTH_X, DRIFT_AT = 24, 12


def watch_cfg(pkg):
    return P(pkg, "serve.obs").MonitorConfig(
        window=8, min_warm=4, min_n=5, cooldown=4, merge_gap=8, lookback=10,
        baseline_max=48)


def drift_queries():
    return ([trap_query(i, 1940 + 5 * i) for i in range(3)],
            [fast_query(i) for i in range(5)])


def replan_agent(pkg):
    """tests/test_monitor.py's stats-driven planner: `pkg`'s
    `CboReplanAgent`."""
    traps, fasts = drift_queries()
    return P(pkg, "baselines").CboReplanAgent(meta_for(pkg, traps + fasts),
                                              max_steps=3)


def drift_stream(db):
    from repro.serve.deltas import DeltaBatch
    from repro.serve.scheduler import Arrival
    rng = np.random.default_rng(11)
    traps, fasts = drift_queries()
    mi_rows = db.table("movie_info").nrows
    t, out = 0.0, []
    for i in range(36):
        t += float(rng.exponential(0.5))
        q = traps[(i // 3) % 3] if i % 3 == 0 else fasts[i % 5]
        out.append(Arrival(t, query=q, seed=int(rng.integers(2 ** 31)),
                           deadline=t + 30.0))
        if i + 1 == DRIFT_AT:
            out.append(Arrival(t, delta=DeltaBatch(
                "movie_info", n_append=GROWTH_X * mi_rows, seed=999)))
    return out


def drift_serve(pkg, *, monitor=None, hooks=(), obs=None):
    D = P(pkg, "serve.deltas")
    db = P(pkg, "sql.datagen").make_job_like(scale=0.06, seed=0)
    D.apply_delta(db, D.DeltaBatch("movie_info", delete_frac=0.9, seed=7))
    db.stats = P(pkg, "sql.catalog").analyze(db,
                                             rng=np.random.default_rng(0))
    stream = of(pkg, drift_stream(db))
    svc = P(pkg, "serve.service").QueryService(
        db, replan_agent(pkg), est=P(pkg, "sql.cbo").Estimator(db, db.stats),
        n_lanes=2, cluster=P(pkg, "sql.cluster").ClusterModel(
            materialize_cap=1_500_000, timeout=60.0, oom_charge="detect",
            oom_spill_penalty=5.0),
        hooks=list(hooks), monitor=monitor, obs=obs)
    comps, stats = svc.run(stream)
    return comps, stats, svc, stream


def outage(pkg, *, own_tracer):
    mon = P(pkg, "serve.obs").SloMonitor(config=watch_cfg(pkg))
    comps, stats, svc, stream = drift_serve(
        pkg, monitor=mon, obs=tracer(pkg) if own_tracer else None)
    t = svc.scheduler.obs
    assert isinstance(t, P(pkg, "serve.obs").Tracer)
    d = stats.as_dict()
    d.pop("hook_seconds")                       # host wall time
    return ([comp_key(c) for c in comps], d,
            [(i.id, i.t_open, i.closed, i.top.cause if i.top else None,
              [h.cause for h in i.hypotheses], i.as_dict())
             for i in mon.incidents],
            [e.as_dict() for e in t.events], mon.records,
            next(a.t for a in stream if a.delta is not None))


@pytest.mark.parametrize("own_tracer", [True, False])
def test_monitor_outage_matches_reference(own_tracer):
    """The drift outage is detected after the delta and blamed on
    movie_info's stale statistics, with the reference's incidents, causes,
    events and per-completion records; `monitor=` without `obs=` serves
    with a `Tracer` of its own and finds the same."""
    ref, port = both(outage, own_tracer=own_tracer)
    assert port == ref
    comps, _, incidents, events, records, t_drift = port
    assert any(k[8] for k in comps), "the trap must be armed"
    after = [i for i in incidents if i[1] >= t_drift]
    assert after and after[0][2] and after[0][3] == "stats_drift"
    assert "policy_swap" not in after[0][4]
    kinds = {e["kind"] for e in events}
    assert {"anomaly", "incident_open", "incident_rca",
            "incident_close"} <= kinds
    assert len(records) == len(comps)


def test_monitor_on_bit_identical_and_reset_clears():
    pkg = "repro_torch"
    off, _, _, _ = drift_serve(pkg)
    mon = P(pkg, "serve.obs").SloMonitor(config=watch_cfg(pkg))
    on, _, svc, _ = drift_serve(pkg, monitor=mon)
    assert [comp_key(c) for c in off] == [comp_key(c) for c in on]
    assert mon.records and mon.incidents
    svc.reset_stats(clear_entries=True)
    assert mon.records == [] and mon.incidents == []
    assert len(mon.ledger) == 0 and mon.totals() == (0, 0)


def alert_heal(pkg):
    O = P(pkg, "serve.obs")
    ctl = P(pkg, "serve.drift").DriftController()
    alerts = O.AlertHooks(drift=ctl)
    mon = O.SloMonitor(config=watch_cfg(pkg), alerts=alerts)
    comps, _, svc, _ = drift_serve(pkg, monitor=mon, hooks=[ctl])
    summary = ctl.summary()
    for k in ("analyze_wall_s", "host_seconds"):        # host wall time
        summary.pop(k)
    return ([comp_key(c) for c in comps], alerts.log,
            svc.scheduler.task_log, summary)


def test_alert_driven_reanalyze_matches_reference():
    ref, port = both(alert_heal)
    assert port == ref
    comps, log, task_log, summary = port
    assert any(e["sink"] == "drift" and "movie_info" in e["tables"]
               for e in log)
    t_fix = next(t for t, lbl in task_log
                 if lbl.startswith("re-analyze[alert]:"))
    assert summary["refresh_events"] >= 1
    assert not any(k[8] for k in comps if k[4] > t_fix)


@pytest.mark.parametrize("module", ["export", "report"])
def test_obs_selftest_pipeline_on_the_cpu(module, monkeypatch, tmp_path):
    """The selftests build `AqoraAgent(...)` without a device, which on
    the port means the card (chip_smoke.py runs them there). Here the
    same pipeline runs with the agent's device set to the CPU."""
    A = P("repro_torch", "core.agent")

    class CpuAgent(A.AqoraAgent):
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)
    monkeypatch.setattr(A, "AqoraAgent", CpuAgent)
    path = tmp_path / f"{module}.jsonl"
    assert P("repro_torch", f"serve.obs.{module}")._selftest(str(path)) == 0
    assert path.exists()
