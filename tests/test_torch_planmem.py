"""The port's plan memory and superoptimizer (serve/plans) against the
reference's, on the CPU.

The scenarios of tests/test_planmem.py through both packages on the same
inputs: memory off is completion-identical to no memory; a hit replays
the stored sequence without calling `act_batch` (counted on the port's
seeded agent); deltas and re-ANALYZEs fence entries; the superoptimizer
promotes exactly the reference's sequences at the same points; a
checkpoint round trip is bit-identical, and a plan-memory directory
written by either package loads in the other; the QoS memo rung, the
harvester seam, the tracer's events and the service's stats. Every
comparison is exact: no float here comes from the policy's net. The
superoptimizer's `host_seconds` (host clock) is left out.
"""
import pytest

torch = pytest.importorskip("torch")

from scenarios import (FixedPredictor, barrier_stream,  # noqa: E402
                       fast_query, mi_join_query, trap_query)
from torch_scenarios import (P, PKGS, arrivals, both,  # noqa: E402
                             cold_agent, comp_key, fresh_db, noop_agent_for,
                             of)


def sched_for(pkg, db, agent, **kw):
    return P(pkg, "serve.scheduler").LaneScheduler(
        db, P(pkg, "sql.cbo").Estimator(db, db.stats), agent, **kw)


def memory(pkg, **kw):
    return P(pkg, "serve.plans").PlanMemory(**kw)


def entries(mem):
    return [e.as_dict() for e in mem.entries()]


# ------------------------------------------------- off => bit-identical
def memory_off(pkg):
    qs = [trap_query(0, 1980), fast_query(0), mi_join_query()]
    stream = arrivals([(0.1 * i, qs[i % 3], i) for i in range(9)])
    agent = noop_agent_for(pkg, *qs, max_steps=2)
    plain = sched_for(pkg, fresh_db(pkg), agent, n_lanes=2).run(
        of(pkg, stream))
    mem = memory(pkg, ingest_serving=False)
    memo = sched_for(pkg, fresh_db(pkg), agent, n_lanes=2,
                     plan_memory=mem).run(of(pkg, stream))
    return ([comp_key(c) for c in plain], [comp_key(c) for c in memo],
            mem.stats(), len(mem))


def test_memory_off_identical_and_equal_to_reference():
    ref, port = both(memory_off)
    assert port == ref
    plain, memo, stats, n = port
    assert plain == memo and stats["hits"] == 0 and n == 0
    assert stats["probes"] == 9


# ------------------------------------------------------------- replay
def hit_replay(pkg):
    q = trap_query(0, 1980)
    agent = noop_agent_for(pkg, q, max_steps=2)
    base = sched_for(pkg, fresh_db(pkg), agent, n_lanes=1)
    base_comps = base.run(of(pkg, arrivals([(0.0, q, 1)])))
    db = fresh_db(pkg)
    mem = memory(pkg, ingest_serving=False)
    e = mem.install(of(pkg, q), db.versions, (0,), cost=0.5,
                    source="superopt")
    sched = sched_for(pkg, db, agent, n_lanes=1, plan_memory=mem)
    comps = sched.run(of(pkg, arrivals([(0.0, q, 1)])))
    return ([comp_key(c) for c in base_comps], [comp_key(c) for c in comps],
            sum(base.decide_sizes), sum(sched.decide_sizes), e.as_dict(),
            mem.stats())


def test_hit_replays_the_stored_sequence_like_reference():
    ref, port = both(hit_replay)
    assert port == ref
    (base,), (c,), base_decided, decided, entry, stats = port
    assert c[15] and c[-1] == (0,) and base[-1] != (0,)
    assert base_decided > 0 and decided == 0
    assert c[7] < base[7] and stats["hits"] == 1


def test_hit_makes_no_act_batch_call_on_the_port_agent():
    """A memoized query is served by the stored sequence: the port's
    seeded agent is never asked (its act_batch calls are counted), while
    the query it has not memoized goes through it."""
    pkg = "repro_torch"
    wl = P(pkg, "sql.workloads").Workload(
        name="mem", max_tables=3, train=of(pkg, [trap_query(0, 1980),
                                                 fast_query(0)]), test=[])
    agent = cold_agent(pkg, wl, max_steps=2)
    calls = []
    inner = agent.act_batch

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return inner(*a, **k)
    agent.act_batch = counting
    db = fresh_db(pkg)
    mem = memory(pkg, ingest_serving=False)
    q = of(pkg, trap_query(0, 1980))
    mem.install(q, db.versions, (0,), cost=0.5, source="superopt")
    sched = sched_for(pkg, db, agent, n_lanes=1, plan_memory=mem)
    comps = sched.run(of(pkg, arrivals([(0.0, trap_query(0, 1980), 1)])))
    assert comps[0].memoized and tuple(comps[0].traj.actions) == (0,)
    assert calls == [] and sum(sched.decide_sizes) == 0
    sched = sched_for(pkg, db, agent, n_lanes=1, plan_memory=mem)
    comps = sched.run(of(pkg, arrivals([(0.0, fast_query(0), 2)])))
    assert not comps[0].memoized
    assert len(calls) == len(comps[0].traj.actions) > 0


def serving_ingest(pkg):
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    mem = memory(pkg)
    sched = sched_for(pkg, fresh_db(pkg), agent, n_lanes=1, plan_memory=mem)
    comps = sched.run(of(pkg, arrivals([(0.2 * i, q, i) for i in range(4)])))
    return [comp_key(c) for c in comps], mem.stats(), sum(sched.decide_sizes)


def test_serving_ingest_memoizes_repeats_like_reference():
    ref, port = both(serving_ingest)
    assert port == ref
    comps, stats, _ = port
    assert [k[15] for k in comps] == [False, True, True, True]
    assert stats["hits"] == 3


# ------------------------------------------------------------ fencing
def delta_fence(pkg):
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    mem = memory(pkg)
    sched = sched_for(pkg, fresh_db(pkg), agent, n_lanes=1, plan_memory=mem)
    comps = sched.run(of(pkg, barrier_stream(q, "movie_info", n_pre=3,
                                             n_post=2)))
    prior = mem.prior(of(pkg, q), {"movie_info": 0, "title": 0,
                                   "movie_keyword": 0})
    db = fresh_db(pkg)
    mem2 = memory(pkg)
    mem2.install(of(pkg, mi_join_query()), db.versions, (0,), cost=1.0)
    mem2.install(of(pkg, fast_query(0)), db.versions, (0,), cost=1.0)
    n = mem2.note_stats_refresh(["movie_info"])
    return ([comp_key(c) for c in comps], entries(mem), mem.stats(),
            prior is not None, n, entries(mem2),
            mem2.would_hit(of(pkg, fast_query(0)), db.versions),
            mem2.would_hit(of(pkg, mi_join_query()), db.versions))


def test_delta_and_stats_fencing_match_reference():
    ref, port = both(delta_fence)
    assert port == ref
    comps, ents, stats, has_prior, n, ents2, hit_fast, hit_mi = port
    assert [k[15] for k in comps] == [False, True, True, False, True]
    assert stats["fenced"] >= 1 and has_prior
    assert any(e["fenced"] and e["fence_reason"] == "delta" for e in ents)
    assert n == 1 and hit_fast and not hit_mi
    assert [e["fence_reason"] for e in ents2 if e["fenced"]] == ["re-analyze"]


def controller_fence(pkg):
    Dr = P(pkg, "serve.drift")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    mem = memory(pkg)
    ctl = Dr.DriftController(policy=Dr.RefreshPolicy("threshold",
                                                     threshold=0.0),
                             plan_memory=mem)
    sched = sched_for(pkg, fresh_db(pkg), agent, n_lanes=1, plan_memory=mem)
    ctl.attach(sched)
    comps = sched.run(of(pkg, barrier_stream(q, "movie_info", n_pre=2,
                                             n_post=2)))
    return ([comp_key(c) for c in comps], entries(mem), mem.stats(),
            ctl.stats.tables_refreshed, sched.task_log)


def test_drift_controller_refresh_fences_memory_like_reference():
    ref, port = both(controller_fence)
    assert port == ref
    assert port[3] >= 1 and port[2]["fenced"] >= 1


# ------------------------------------------------------- superoptimizer
def superopt_pass(pkg):
    qs = [trap_query(i % 2, 1980) for i in range(10)]
    agent = noop_agent_for(pkg, *qs, max_steps=2)
    mem = memory(pkg)
    so = P(pkg, "serve.plans").Superoptimizer(mem, opt_every=4,
                                              sim_budget=16)
    sched = sched_for(pkg, fresh_db(pkg), agent, n_lanes=2, plan_memory=mem)
    so.attach(sched)
    comps = sched.run(of(pkg, arrivals([(0.2 * i, q, i)
                                        for i, q in enumerate(qs)])))
    stats = so.stats.as_dict()
    stats.pop("host_seconds")                           # host wall time
    return ([comp_key(c) for c in comps], so.promote_log, stats,
            mem.stats(), entries(mem))


def test_superoptimizer_promotions_equal_reference():
    ref, port = both(superopt_pass)
    assert port == ref
    comps, log, stats, mstats, _ = port
    assert stats["promotions"] >= 1
    assert all(p["incumbent_cost"] is None or p["cost"] < p["incumbent_cost"]
               for p in log)
    assert any(k[15] and k[-1] == tuple(log[0]["actions"]) for k in comps)
    assert mstats["promoted_superopt"] == stats["promotions"]
    assert port == both(superopt_pass)[1]                 # deterministic


def superopt_incumbent(pkg):
    q = trap_query(0, 1980)
    agent = noop_agent_for(pkg, q, max_steps=2)
    db = fresh_db(pkg)
    mem = memory(pkg, ingest_serving=False)
    best = mem.install(of(pkg, q), db.versions, (0,), cost=0.529,
                       source="superopt")
    so = P(pkg, "serve.plans").Superoptimizer(mem, opt_every=2,
                                              sim_budget=16)
    sched = sched_for(pkg, db, agent, n_lanes=1, plan_memory=mem)
    so.attach(sched)
    sched.run(of(pkg, arrivals([(0.2 * i, q, i) for i in range(4)])))
    # heat from the plan ledger wins over the local count
    ledger = P(pkg, "serve.obs.monitor").PlanLedger()
    sig = P(pkg, "serve.plans").template_signature(of(pkg, q))
    band = P(pkg, "serve.plans").band_for(of(pkg, q), db.versions)
    for _ in range(5):
        ledger.observe(0, q.name, band, 0.6, False)
    so2 = P(pkg, "serve.plans").Superoptimizer(memory(pkg), ledger=ledger)
    so2._heat[(sig, band)] = 1
    so2._repr[(sig, band)] = of(pkg, q)
    heat = so2._heat_of((sig, band))
    so2.ledger = None
    return (so.stats.rounds, mem.prior(of(pkg, q), db.versions) is best,
            best.fenced, so.promote_log, heat, so2._heat_of((sig, band)))


def test_superoptimizer_keeps_incumbent_and_reads_ledger_like_reference():
    ref, port = both(superopt_incumbent)
    assert port == ref
    rounds, kept, fenced, _, heat, local = port
    assert rounds >= 1 and kept and not fenced
    assert (heat, local) == (5, 1)


# ---------------------------------------------------------- persistence
def saved_memory(pkg, directory):
    db = fresh_db(pkg)
    mem = memory(pkg, band_width=2)
    e = mem.install(of(pkg, mi_join_query()), db.versions, (0, 3),
                    cost=0.123456789,
                    decoded=("('cbo', 1)", "('lead', 0)"), t=4.2)
    e.observe(0.777)
    mem.install(of(pkg, fast_query(1)), db.versions, (), cost=2.5,
                source="serve")
    mem.fence_table("movie_info", "delta", t=5.0)
    return mem, mem.save(directory), db


def test_checkpoint_round_trip_and_directories_cross(tmp_path):
    """save -> load restores the memory bit for bit on the port, a second
    save takes a new step, and a directory written by either package
    loads in the other to the same `to_dict()`."""
    PM = {pkg: P(pkg, "serve.plans").PlanMemory for pkg in PKGS}
    mem, step, db = saved_memory("repro_torch", tmp_path / "port")
    back = PM["repro_torch"].load(tmp_path / "port", step)
    assert back.to_dict() == mem.to_dict()
    got = back.prior(of("repro_torch", fast_query(1)), db.versions)
    assert got is not None and got.actions == ()
    mem.install(of("repro_torch", fast_query(2)), db.versions, (1,),
                cost=0.5)
    step2 = mem.save(tmp_path / "port")
    assert step2 != step
    assert len(PM["repro_torch"].load(tmp_path / "port")) == len(mem)

    ref_mem, ref_step, _ = saved_memory("repro", tmp_path / "ref")
    assert ref_mem.to_dict() == back.to_dict()
    assert PM["repro_torch"].load(tmp_path / "ref", ref_step).to_dict() == \
        ref_mem.to_dict()
    assert PM["repro"].load(tmp_path / "port").to_dict() == mem.to_dict()
    empty, _, _ = P("repro_torch", "checkpoint").Checkpointer(
        tmp_path / "port").restore({}, step=step)
    assert empty == {}


# ------------------------------------------------------------ QoS rung
def memo_rung(pkg):
    Q = P(pkg, "serve.qos")
    q = fast_query(0)
    agent = noop_agent_for(pkg, q, max_steps=2)
    db = fresh_db(pkg)
    mem = memory(pkg, ingest_serving=False)
    mem.install(of(pkg, q), db.versions, (), cost=0.25)
    lad = Q.DegradationLadder.with_memo_rung()
    adm = Q.QoSAdmission(Q.TenantRegistry(), predictor=FixedPredictor(),
                         ladder=lad, plan_memory=mem)
    sched = sched_for(pkg, db, agent, n_lanes=1, admission=adm,
                      plan_memory=mem)
    from repro.serve.scheduler import Arrival
    comps = sched.run(of(pkg, [Arrival(0.0, query=q, seed=1,
                                       deadline=0.2)]))
    return ([comp_key(c) for c in comps], adm.stats(),
            [lad.choose(*a, memo_hit=h) for a, h in
             (((1.0, 2.0), True), ((6.0, 1.0), True), ((6.0, 1.0), False),
              ((9.0, 1.0), True))])


def test_memo_rung_admits_on_a_hit_like_reference():
    ref, port = both(memo_rung)
    assert port == ref
    (c,), stats, _ = port
    assert c[15] and stats["memo_admits"] == 1


# ----------------------------------------------------- harvester seam
def harvester_seam(pkg):
    Lrn = P(pkg, "learn")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    db = fresh_db(pkg)
    mem = memory(pkg, ingest_serving=False)
    e = mem.install(of(pkg, q), db.versions, (10,), cost=1.0)
    harv = Lrn.TrajectoryHarvester(plan_memory=mem)
    sched = sched_for(pkg, db, agent, n_lanes=1, plan_memory=mem)
    harv.attach(sched)
    comps = sched.run(of(pkg, arrivals([(0.2 * i, q, i) for i in range(3)])))
    mem2 = memory(pkg, ingest_serving=False)
    e2 = mem2.install(of(pkg, q), db.versions, (10,), cost=1.0)
    e2.fenced = True
    harv2 = Lrn.TrajectoryHarvester(plan_memory=mem2)
    sched2 = sched_for(pkg, fresh_db(pkg), agent, n_lanes=1,
                       plan_memory=mem2)
    harv2.attach(sched2)
    comps2 = sched2.run(of(pkg, arrivals([(0.0, q, 1)])))
    return ([comp_key(c) for c in comps + comps2], e.as_dict(),
            e2.as_dict(), (harv.n_memoized, harv.n_harvested,
                           harv2.n_fed_back, harv2.n_harvested))


def test_harvester_seam_matches_reference():
    ref, port = both(harvester_seam)
    assert port == ref
    assert port[3] == (3, 0, 1, 1)


# ------------------------------------------------------- obs + service
def obs_events(pkg):
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    mem = memory(pkg)
    tracer = P(pkg, "serve.obs").Tracer()
    sched = sched_for(pkg, fresh_db(pkg), agent, n_lanes=1)
    tracer.attach(sched)
    mem.attach(sched)
    sched.run(of(pkg, barrier_stream(q, "movie_info", n_pre=2, n_post=2)))
    svc = P(pkg, "serve.service").QueryService(fresh_db(pkg), agent,
                                               n_lanes=2, plan_memory=memory(
                                                   pkg))
    comps, stats = svc.run_queries(of(pkg, [q] * 4))
    d = stats.as_dict()
    d.pop("hook_seconds")                               # host wall time
    return ([e.as_dict() for e in tracer.events],
            tracer.metrics.snapshot()["counters"],
            [comp_key(c) for c in comps], d)


def test_obs_events_and_service_stats_match_reference():
    ref, port = both(obs_events)
    assert port == ref
    events, counters, comps, d = port
    assert {"plan_memory_miss", "plan_memory_hit", "plan_memory_promoted",
            "plan_memory_fenced"} <= {e["kind"] for e in events}
    assert counters["events[plan_memory_hit]"] >= 1
    assert d["n_memoized"] == sum(k[15] for k in comps) > 0
