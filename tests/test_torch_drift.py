"""The port's drift control plane (serve/drift) against the reference's,
on the CPU.

The scenarios of tests/test_drift.py through both packages on the same
inputs and weights: the detector's scores, `RefreshPolicy("never")`
bit-identical to no controller, re-ANALYZE as a write barrier with the
catalog catching up, the refresh policies' kinds, budget and cooldown,
coverage probes, the predictor's `refit_on_drift` with its generation
fence (the port's `LatencyPredictor` against the reference's), and the
controller's refit trigger and cooldown. Completions, task logs, refresh
logs and controller stats are identical; the stats' host-clock fields
(`analyze_wall_s`, `host_seconds`) are left out. Predictions agree within
1e-5 relative, losses within 1e-5 of max(loss, 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenarios import (drifting_delta_stream, fast_query,  # noqa: E402
                       mi_join_query, straggler_query, trap_query)
from torch_scenarios import (P, PKGS, both, cold_agent, comp_key,  # noqa: E402
                             fresh_db, job_workload, max_logp_diff, of,
                             plain)

PRED_RTOL = 1e-5
HOST_CLOCK = ("analyze_wall_s", "host_seconds")


@pytest.fixture(scope="module")
def agents(agent):
    """The reference's cold serving agent (conftest) and the port's."""
    return {"repro": agent,
            "repro_torch": cold_agent("repro_torch",
                                      job_workload("repro_torch"))}


def drift(pkg, table, score, lag=1):
    return P(pkg, "serve.drift").TableDrift(table, lag, 1.0, 0.0, 0.0, score)


def summary_of(ctl):
    s = ctl.summary()
    for k in HOST_CLOCK:
        s.pop(k)
    return s


def serve_with(pkg, agent, stream, hooks, n_lanes=2, db=None):
    db = fresh_db(pkg, scale=0.05) if db is None else db
    svc = P(pkg, "serve.service").QueryService(
        db, agent, est=P(pkg, "sql.cbo").Estimator(db, db.stats),
        n_lanes=n_lanes, hooks=hooks)
    comps, _ = svc.run(of(pkg, stream))
    return comps, svc


# --------------------------------------------------------------- detector
def detector_scores(pkg):
    D = P(pkg, "serve.deltas")
    analyze = P(pkg, "sql.catalog").analyze
    db = fresh_db(pkg, scale=0.05)
    det = P(pkg, "serve.drift").DriftDetector()
    det.snapshot(db)
    out = []
    for _ in range(8):
        det.observe(("title",), regret=3.0, pred_err=2.0)
    out.append(det.score_table(db, "title"))
    D.apply_delta(db, D.DeltaBatch("movie_info", n_append=5000, seed=1))
    out.append(det.score_table(db, "movie_info"))
    det.observe(("movie_info",), regret=2.0, pred_err=1.0)
    out.append(det.score_table(db, "movie_info"))
    D.apply_delta(db, D.DeltaBatch("movie_info", n_append=100, seed=2))
    out.append(det.score_table(db, "movie_info"))
    det.note_refreshed("movie_info", db.table_version("movie_info"))
    out.append(det.score_table(db, "movie_info"))
    # staleness that predates the detector's attachment
    db2 = fresh_db(pkg, scale=0.05)
    db2.stats = analyze(db2, rng=np.random.default_rng(3))
    D.apply_delta(db2, D.DeltaBatch("movie_info", n_append=2000, seed=1))
    det2 = P(pkg, "serve.drift").DriftDetector()
    det2.snapshot(db2)
    out.append(det2.score_table(db2, "movie_info"))
    out.append(sorted(det.score(db).items()))
    return out


def test_detector_scores_match_reference():
    ref, port = both(detector_scores)
    assert port == ref
    zero, base, amped, lag2, fresh, pre_attach, _ = port
    f = lambda d: d[1]                                     # noqa: E731
    assert f(zero)["version_lag"] == 0 and f(zero)["score"] == 0.0
    assert f(zero)["regret"] > 0
    assert f(amped)["score"] > f(base)["score"] > 0
    assert f(lag2)["version_lag"] == 2 and f(fresh)["score"] == 0.0
    assert f(pre_attach)["version_lag"] == 1 and f(pre_attach)["score"] > 0


def threshold_run(pkg, agent):
    Lrn, Dr = P(pkg, "learn"), P(pkg, "serve.drift")
    rb = Lrn.ReplayBuffer()
    ctl = Dr.DriftController(policy=Dr.RefreshPolicy("threshold",
                                                     threshold=0.5),
                             replay=rb)
    stream = drifting_delta_stream(
        [fast_query(i) for i in range(4)], n_queries=10, seed=21,
        drift_table="movie_info", drift_at=4, growth_rows=4000,
        churn_table="movie_keyword", churn_every=3, churn_rows=200)
    comps, svc = serve_with(pkg, agent, stream,
                            [Lrn.TrajectoryHarvester(rb), ctl])
    return ([comp_key(c) for c in comps], svc.scheduler.task_log,
            ctl.refresh_log, sorted(ctl.scores().items()), summary_of(ctl))


def test_threshold_controller_deterministic_and_equal_to_reference(agents):
    ref = plain_run(threshold_run, "repro", agents)
    port = plain_run(threshold_run, "repro_torch", agents)
    assert port == ref
    assert port == plain_run(threshold_run, "repro_torch", agents)
    assert port[1] and port[4]["refresh_events"] >= 1


def plain_run(fn, pkg, agents, *args):
    return plain(fn(pkg, agents[pkg], *args))


# ------------------------------------------------- never == no controller
def never_run(pkg, agent, with_controller):
    Lrn, Dr = P(pkg, "learn"), P(pkg, "serve.drift")
    stream = drifting_delta_stream(
        [fast_query(i) for i in range(4)], n_queries=12, seed=33,
        drift_table="movie_info", drift_at=5, growth_rows=4000)
    hooks = []
    if with_controller:
        rb = Lrn.ReplayBuffer()
        hooks = [Lrn.TrajectoryHarvester(rb),
                 Dr.DriftController(policy=Dr.RefreshPolicy("never"),
                                    replay=rb)]
    comps, svc = serve_with(pkg, agent, stream, hooks)
    return comps, svc.scheduler.task_log


def test_refresh_never_bit_identical_to_no_controller(agents):
    port = "repro_torch"
    plain_c, _ = never_run(port, agents[port], False)
    gated, task_log = never_run(port, agents[port], True)
    ref, _ = never_run("repro", agents["repro"], True)
    assert task_log == []
    assert [comp_key(c) for c in plain_c] == [comp_key(c) for c in gated]
    np.testing.assert_array_equal(
        np.concatenate([c.traj.logps for c in plain_c]),
        np.concatenate([c.traj.logps for c in gated]))
    assert [comp_key(c) for c in gated] == [comp_key(c) for c in ref]
    assert max_logp_diff(gated, ref) <= 1e-4


# ----------------------------------------------------- re-ANALYZE barrier
def barrier_run(pkg, agent, kind, charge):
    Lrn, Dr = P(pkg, "learn"), P(pkg, "serve.drift")
    db = fresh_db(pkg, scale=0.05)
    stale_rows = db.stats.tables["movie_info"].nrows
    rb = Lrn.ReplayBuffer()
    pol = Dr.RefreshPolicy(kind, **({"threshold": 0.5}
                                    if kind == "threshold" else {}))
    ctl = Dr.DriftController(policy=pol, replay=rb, charge_virtual=charge)
    stream = drifting_delta_stream(
        [fast_query(i) for i in range(4)], n_queries=10, seed=5,
        drift_table="movie_info", drift_at=4, growth_rows=5000) \
        if kind == "threshold" else drifting_delta_stream(
        [fast_query(i) for i in range(4)], n_queries=8, seed=11,
        drift_table="movie_info", drift_at=3, growth_rows=3000)
    comps, svc = serve_with(pkg, agent, stream,
                            [Lrn.TrajectoryHarvester(rb), ctl], db=db)
    return ([comp_key(c) for c in comps], svc.scheduler.task_log,
            svc.scheduler.delta_log, ctl.refresh_log, summary_of(ctl),
            ctl.stats.analyze_modeled_s, (stale_rows, db.stats.tables["movie_info"].nrows,
             svc.est.stats.tables["movie_info"].nrows,
             db.table("movie_info").nrows))


@pytest.mark.parametrize("kind,charge", [("threshold", False),
                                         ("threshold", True),
                                         ("always", False)])
def test_reanalyze_write_barrier_matches_reference(agents, kind, charge):
    """The refresh lands as a write barrier (earlier queries drain before
    it, later ones admit after it; with `always` at the delta's own
    barrier), the catalog catches up with the live table, and a charged
    window shifts the barrier by the modeled analyze seconds."""
    ref = plain_run(barrier_run, "repro", agents, kind, charge)
    port = plain_run(barrier_run, "repro_torch", agents, kind, charge)
    assert port == ref
    comps, task_log, delta_log, _, summary, modeled_s, rows = port
    t_task, label = task_log[0]
    assert "movie_info" in label and summary["analyze_modeled_s"] > 0
    assert all(k[5] <= t_task for k in comps if k[4] < t_task)
    stale, catalog, est, live = rows
    assert catalog == est == live != stale
    if kind == "always":
        assert t_task == delta_log[0][0]
    if charge:
        free = plain_run(barrier_run, "repro_torch", agents, kind, False)
        assert task_log[0][0] == pytest.approx(
            free[1][0][0] + modeled_s)


# --------------------------------------------------------- refresh policy
def policy_decisions(pkg):
    Dr = P(pkg, "serve.drift")
    cost = lambda t: 1.0                                   # noqa: E731
    drifts = {"a": drift(pkg, "a", 3.0), "b": drift(pkg, "b", 0.4),
              "c": Dr.TableDrift("c", 0, 1.0, 0.0, 0.0, 0.0)}
    out = [Dr.RefreshPolicy(k, **kw).decide(drifts, 0.0, cost)
           for k, kw in (("never", {}), ("always", {}),
                         ("threshold", {"threshold": 1.0}))]
    drifts = {"a": drift(pkg, "a", 3.0), "b": drift(pkg, "b", 2.0),
              "d": drift(pkg, "d", 1.5)}
    pol = Dr.RefreshPolicy("budgeted", threshold=1.0, budget_s=2.5)
    dec = pol.decide(drifts, 0.0, cost)
    out += [dec, pol.spent_modeled_s, pol.decide(drifts, 1.0, cost)]
    for t in dec.tables:
        pol.note_refreshed(t, 0.0)
    out += [pol.spent_modeled_s, pol.stats()]
    pol2 = Dr.RefreshPolicy("budgeted", threshold=1.0, budget_s=1.2)
    out.append(pol2.decide(drifts, 0.0,
                           lambda t: 1.0 if t == "a" else 0.2))
    pol3 = Dr.RefreshPolicy("always", min_interval=10.0)
    out.append(pol3.decide(drifts, 0.0, lambda t: 0.0))
    pol3.note_refreshed("a", 0.0)
    out += [pol3.decide(drifts, t, lambda t: 0.0) for t in (5.0, 10.0)]
    return out


def test_refresh_policy_kinds_budget_and_cooldown_match_reference():
    ref, port = both(policy_decisions)
    assert port == ref
    tables = lambda d: d[1]["tables"]                     # noqa: E731
    assert [tables(d) for d in port[:3]] == [(), ("a", "b"), ("a",)]
    assert tables(port[3]) == ("a", "b") and port[4] == 2.0
    assert tables(port[5]) == () and port[6] == 2.0
    assert tables(port[8]) == ("a", "b")
    assert [tables(d) for d in port[9:]] == [("a", "b", "d"), ("b", "d"),
                                             ("a", "b", "d")]
    for bad in ({"kind": "bogus"}, {"kind": "budgeted"}):
        with pytest.raises(AssertionError):
            P("repro_torch", "serve.drift").RefreshPolicy(**bad)


# -------------------------------------------------------- probe coverage
def probe_sets(pkg):
    Dr = P(pkg, "serve.drift")
    pool = of(pkg, [trap_query(i, 1940 + i) for i in range(8)]
              + [fast_query(i) for i in range(8)])
    cover = Dr.CoverageProbeSet(pool, k=6, seed=11)
    drifts = {"cast_info": drift(pkg, "cast_info", 8.0)}
    flat = [q.name for q in cover.resample({})]
    hot = [q.name for q in cover.resample(drifts)]
    return flat, hot, cover.weights(drifts).tolist(), cover.stats()


def test_coverage_probes_match_reference():
    ref, port = both(probe_sets)
    assert port == ref
    flat, hot, w, _ = port
    touches = lambda names: sum(n.startswith("trap") for n in names)  # noqa
    assert touches(hot) > touches(flat) and touches(hot) >= 5
    assert min(w) > 0 and max(w) > 10 * min(w)


def controller_probes(pkg, agent, tmp_path):
    Lrn, Dr = P(pkg, "learn"), P(pkg, "serve.drift")
    pool = of(pkg, [trap_query(i, 1940 + i) for i in range(6)]
              + [fast_query(i) for i in range(6)])
    rb = Lrn.ReplayBuffer()
    store = Lrn.PolicyStore(tmp_path / pkg, of(pkg, [fast_query(0),
                                                     fast_query(1)]))
    ctl = Dr.DriftController(policy=Dr.RefreshPolicy("never"), replay=rb,
                             store=store,
                             probes=Dr.CoverageProbeSet(pool, k=4, seed=2),
                             probe_threshold=0.5)
    comps, _ = serve_with(pkg, agent, drifting_delta_stream(
        [fast_query(i) for i in range(3)], n_queries=8, seed=13,
        drift_table="cast_info", drift_at=3, growth_rows=20000),
        [Lrn.TrajectoryHarvester(rb), ctl])
    return ([comp_key(c) for c in comps], [q.name for q in store.probe],
            store.probe_log, summary_of(ctl))


def test_controller_installs_coverage_probes_like_reference(agents,
                                                            tmp_path):
    ref = plain_run(controller_probes, "repro", agents, tmp_path)
    port = plain_run(controller_probes, "repro_torch", agents, tmp_path)
    assert port == ref
    _, probe, _, summary = port
    assert summary["probe_resamples"] == 1
    assert sum(n.startswith("trap") for n in probe) >= 2


# ------------------------------------------------------- refit generation
def straggler_replay(pkg, meta):
    """tests/test_drift.py's replay buffer: 16 failed straggler runs."""
    Experience = P(pkg, "learn.replay").Experience
    Trajectory = P(pkg, "core.rollout").Trajectory
    enc = P(pkg, "serve.qos").encode_query(of(pkg, straggler_query()), meta)
    rb = P(pkg, "learn").ReplayBuffer()
    for i in range(16):
        t = Trajectory()
        t.actions, t.states = [0], [enc]
        rb.add(Experience(seq=i, query_name="straggler", traj=t,
                          latency=300.0, failed=True, finish_t=float(i),
                          tables=("cast_info",), versions={"cast_info": 1}))
    return rb


def predictor(pkg, meta, **kw):
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    return P(pkg, "serve.qos").LatencyPredictor(meta, **kw)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_refit_on_drift_generation_fence_matches_reference(agents):
    """The first refit from the same seeded predictor and replay: the
    same samples, its loss within 1e-5 of max(loss, 1), the prediction
    before and after it within 1e-5 relative; the generation bumps and
    the memo is fenced. The reference test's twelve refits then run on
    the port (they part from the reference's by AdamW's amplification of
    last-bit gradient differences, so only its own properties hold)."""
    runs = {}
    for pkg in PKGS:
        meta = agents[pkg].meta
        pred = predictor(pkg, meta, seed=3, lr=5e-3)
        strag = of(pkg, straggler_query())
        rb = straggler_replay(pkg, meta)
        before, gen0 = pred.predict_query(strag), pred.generation
        assert pred._pred_memo
        loss = pred.refit_on_drift(rb, np.random.default_rng(0),
                                   current_versions={"cast_info": 1},
                                   trigger="test")
        assert pred.generation > gen0 and pred.n_refits == 1
        assert not pred._pred_memo
        runs[pkg] = (before, loss, pred.predict_query(strag),
                     pred.refit_log[-1]["trigger"], pred.stats(), pred, rb)
    ref, port = runs["repro"], runs["repro_torch"]
    assert rel(port[0], ref[0]) <= PRED_RTOL
    assert abs(port[1] - ref[1]) <= 1e-5 * max(abs(ref[1]), 1.0)
    assert rel(port[2], ref[2]) <= PRED_RTOL
    assert port[3:5] == ref[3:5]

    pred, rb = port[5], port[6]
    strag = of("repro_torch", straggler_query())
    for _ in range(11):
        pred.refit_on_drift(rb, np.random.default_rng(0))
    after = pred.predict_query(strag)
    assert after != port[0] and after > 100.0
    gen = pred.generation
    pred.reset_stats()
    assert not pred._pred_memo and not pred._enc_memo
    assert pred.generation == gen and pred.n_refits == 12


def refit_trigger(pkg, agent):
    Lrn, Dr = P(pkg, "learn"), P(pkg, "serve.drift")
    rb = Lrn.ReplayBuffer()
    pred = predictor(pkg, agent.meta, seed=1)
    predictions = []
    inner = pred.predict_query

    def noting(query):
        p = inner(query)
        predictions.append(p)
        return p
    pred.predict_query = noting
    ctl = Dr.DriftController(policy=Dr.RefreshPolicy("never"), replay=rb,
                             predictor=pred, refit_threshold=0.5,
                             refit_every=4, refit_samples=8)
    comps, _ = serve_with(pkg, agent, drifting_delta_stream(
        [fast_query(i) for i in range(4)], n_queries=12, seed=7,
        drift_table="movie_info", drift_at=4, growth_rows=4000),
        [Lrn.TrajectoryHarvester(rb), ctl])
    return comps, ctl, pred, predictions


def test_controller_refit_trigger_and_cooldown_match_reference(agents):
    """The same completions and refits at the same points with the same
    triggers; every prediction the controller takes within 1e-5
    relative, every refit loss within 1e-5 of max(loss, 1)."""
    runs = {pkg: refit_trigger(pkg, agents[pkg]) for pkg in PKGS}
    (comps, ctl, pred, preds), (rcomps, rctl, rpred, rpreds) = \
        runs["repro_torch"], runs["repro"]
    assert [comp_key(c) for c in comps] == [comp_key(c) for c in rcomps]
    assert summary_of(ctl)["refits"] == summary_of(rctl)["refits"] >= 1
    strip = lambda log: [{k: v for k, v in r.items() if k != "loss"}  # noqa
                         for r in log]
    assert strip(pred.refit_log) == strip(rpred.refit_log)
    for a, b in zip(pred.refit_log, rpred.refit_log):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * max(abs(b["loss"]), 1.0)
    assert len(preds) == len(rpreds)
    assert max(rel(a, b) for a, b in zip(preds, rpreds)) <= PRED_RTOL
    assert ctl.stats.refits <= ctl.stats.completions // 4
    assert pred.n_refits == ctl.stats.refits
    again = refit_trigger("repro_torch", agents["repro_torch"])
    assert [r["trigger"] for r in again[2].refit_log] == \
        [r["trigger"] for r in pred.refit_log]


# ------------------------------------------------------ other actuators
def demote_run(pkg, agent):
    Lrn, Dr = P(pkg, "learn"), P(pkg, "serve.drift")
    cur = Lrn.AdaptiveCurriculum(start_stage=3, drift_demote_threshold=0.3)

    class CurriculumWire:
        def attach(self, sched):
            sched.on_complete.append(cur.observe)

    ctl = Dr.DriftController(policy=Dr.RefreshPolicy("never"),
                             curriculum=cur)
    comps, _ = serve_with(pkg, agent, drifting_delta_stream(
        [fast_query(i) for i in range(4)], n_queries=12, seed=11,
        drift_table="movie_info", drift_at=4, growth_rows=6000),
        [CurriculumWire(), ctl])
    return [comp_key(c) for c in comps], cur.stats(), summary_of(ctl)


def test_curriculum_demotion_and_stats_cache_match_reference(agents):
    ref = plain_run(demote_run, "repro", agents)
    port = plain_run(demote_run, "repro_torch", agents)
    assert port == ref
    comps, cur, summary = port
    assert not any(k[8] for k in comps)
    assert cur["drift_demotions"] and summary["curriculum_demotions"] == 1

    # re-ANALYZE keeps the stage cache valid (no version bump)
    def cache(pkg):
        db = fresh_db(pkg, scale=0.06)
        est = P(pkg, "sql.cbo").Estimator(db, db.stats)
        q = of(pkg, mi_join_query("q_reanalyze"))
        plan = P(pkg, "sql.plans").syntactic_plan
        run = P(pkg, "sql.executor").run_adaptive
        r1 = run(db, q, plan(q), est)
        n = len(db._stage_cache)
        for t in ("title", "movie_info", "info_type"):
            db.stats.tables[t] = P(pkg, "sql.catalog").analyze_table(
                db, t, rng=np.random.default_rng(4))
        r2 = run(db, q, plan(q), est)
        return (r1.latency, r2.latency, n, len(db._stage_cache),
                db._stage_cache.stats.invalidations,
                [s.out_rows for s in r2.stages])
    ref, port = both(cache)
    assert port == ref and port[2] == port[3] > 0 and port[4] == 0
