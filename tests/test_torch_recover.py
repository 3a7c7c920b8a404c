"""The port's failure-recovery plane (serve/recover) against the
reference's, on the CPU.

Each scenario of tests/test_recover.py runs through both packages on the
same inputs (the reference's scenario functions, carried over by
`torch_scenarios.port_of`): the injector's draws, the chaos replay, the
disabled injector, resume / crash / give-up retries, the OOM fallback
replan, the hedge race, the breaker (trip and quiet), the service's
failure breakdown and replay tagging. Completions (`comp_key`: every
field a completion decides) and `RecoveryStats` must be identical, and
the reference test's own properties are asserted on the port's run. The
breaker's trip must give the port's agent back its committed parameters
bit for bit (`torch.equal`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenarios import (fast_query, mi_join_query, straggler_query,  # noqa: E402
                       trap_query)
from torch_scenarios import (P, PKGS, arrivals, both,  # noqa: E402
                             comp_key, meta_for, noop_agent_for, of, plain,
                             world)

TRAP_CAP = dict(materialize_cap=400_000, timeout=60.0)


def serve(pkg, agent, stream, *, recovery=None, n_lanes=1, cluster=None,
          world_=None):
    db, est = world_ if world_ is not None else world(pkg)
    sched = P(pkg, "serve.scheduler").LaneScheduler(
        db, est, agent, n_lanes=n_lanes, cluster=cluster, recovery=recovery)
    return sched.run(of(pkg, stream)), sched


# ------------------------------------------------------------- injector
def injector_draws(pkg):
    R = P(pkg, "serve.recover")
    kw = dict(p_crash=0.05, p_transient=0.2, p_slow=0.3, p_corrupt=0.1)
    out = []
    for seed in (42, 43):
        inj = R.FaultInjector(seed=seed, **kw)
        keys = [(s, att, k) for s in range(40) for att in (1, 2, 1001)
                for k in range(4)]
        out.append([(inj.stage_fault(s, att, k), inj.run_slowdown(s, att))
                    for s, att, k in reversed(keys)])
        out.append([inj.admit_corruption(s, ["title", "cast_info",
                                             "movie_info"])
                    for s in range(40)])
    return out


def test_fault_injector_draws_match_reference():
    """The same seeds give the same stage faults, slowdowns and
    corruption picks, in any order of asking."""
    ref, port = both(injector_draws)
    assert port == ref
    assert any(ev is not None for ev, _ in port[0])


def chaos_run(pkg):
    R = P(pkg, "serve.recover")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, *[fast_query(i) for i in range(4)],
                           max_steps=2)
    stream = arrivals([(0.2 * i, q if i % 2 else fast_query(i), i + 1)
                       for i in range(8)])
    inj = R.FaultInjector(seed=5, p_crash=0.05, p_transient=0.3, p_slow=0.2)
    mgr = R.RecoveryManager(injector=inj,
                            retry=R.RetryPolicy(max_attempts=3))
    comps, _ = serve(pkg, agent, stream, recovery=mgr, n_lanes=2)
    return [comp_key(c) for c in comps], mgr.stats.as_dict()


def test_chaos_replay_matches_reference():
    ref, port = both(chaos_run)
    assert port == ref
    assert port == plain(chaos_run("repro_torch"))   # replays bit for bit
    assert any(k[10] > 1 for k in port[0]), "the storm must force retries"


def disabled_injector(pkg):
    from repro.serve.deltas import DeltaBatch
    R = P(pkg, "serve.recover")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, straggler_query(),
                           *[fast_query(i) for i in range(3)], max_steps=2)
    stream = arrivals(
        [(0.0, straggler_query(), 9)]
        + [(0.05 * (i + 1), fast_query(i), i + 1) for i in range(3)]
        + [(0.3, DeltaBatch("movie_info", n_append=900, seed=3), None),
           (0.35, q, 8)])
    base, _ = serve(pkg, agent, stream, n_lanes=2, world_=world(pkg, seed=1))
    inert = R.RecoveryManager(injector=R.FaultInjector(
        seed=7, p_crash=0.5, p_transient=0.4, p_slow=0.9, p_corrupt=0.9,
        enabled=False))
    got, _ = serve(pkg, agent, stream, recovery=inert, n_lanes=2,
                   world_=world(pkg, seed=1))
    return [comp_key(c) for c in base], [comp_key(c) for c in got]


def test_disabled_injector_matches_no_plane_and_reference():
    ref, port = both(disabled_injector)
    assert port == ref
    assert port[0] == port[1]
    timeout = P("repro_torch", "sql.cluster").ClusterModel().timeout
    oom = [k for k in port[0] if k[8]]
    assert oom and all(k[7] == timeout for k in oom)


# ---------------------------------------------------------------- retries
def scripted_retry(pkg, stage, retry_kw):
    R = P(pkg, "serve.recover")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    stream = arrivals([(0.0, q, 5)])
    base, _ = serve(pkg, agent, stream)
    mgr = R.RecoveryManager(injector=R.ScriptedFaults(stage=stage),
                            retry=R.RetryPolicy(**retry_kw))
    comps, _ = serve(pkg, agent, stream, recovery=mgr)
    return ([comp_key(c) for c in base], [comp_key(c) for c in comps],
            mgr.stats.as_dict(), base[0].result.latency,
            [s.seconds for s in base[0].result.stages])


RETRY_CASES = {
    "resume": ({(0, 1, 4): "transient"}, dict(max_attempts=2, backoff=0.25)),
    "crash": ({(0, 1, 4): "crash"}, dict(max_attempts=2, backoff=0.0)),
    "give_up": ({(0, att, 0): "transient" for att in range(1, 10)},
                dict(max_attempts=3, backoff=0.5, backoff_mult=2.0)),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_ladder_matches_reference(case):
    """Resume pays only the failed stage, a crash restarts from scratch,
    and the ladder gives up after max_attempts with one completion."""
    stage, retry_kw = RETRY_CASES[case]
    ref, port = both(scripted_retry, stage, retry_kw)
    assert port == ref
    _, (c,), stats, base_lat, stages = port
    attempts, recovered, service = c[10], c[11], c[5] - c[4]
    if case == "resume":
        assert (attempts, recovered, stats["n_resumed"]) == (2, True, 1)
        assert service == pytest.approx(stages[-1], abs=1e-12)
    elif case == "crash":
        assert (attempts, recovered, stats["n_restarted"]) == (2, True, 1)
        assert service == pytest.approx(base_lat, abs=1e-12)
    else:
        assert (attempts, recovered, c[8]) == (3, False, True)
        assert stats["n_given_up"] == 1
        assert stats["backoff_s"] == pytest.approx(1.5)


def oom_ladder(pkg):
    R = P(pkg, "serve.recover")
    ClusterModel = P(pkg, "sql.cluster").ClusterModel
    DeltaBatch = P(pkg, "serve.deltas").DeltaBatch

    def trap_world():
        db = P(pkg, "sql.datagen").make_job_like(scale=0.06, seed=0)
        est = P(pkg, "sql.cbo").Estimator(db, db.stats)
        P(pkg, "serve.deltas").apply_delta(
            db, DeltaBatch("cast_info", n_append=120_000, seed=9))
        return db, est

    q = trap_query(0, 1900)
    agent = noop_agent_for(pkg, q)
    stream = arrivals([(0.0, q, 5)])
    out = []
    for retry in (None, dict(max_attempts=2, backoff=0.0, fallback=False),
                  dict(max_attempts=2, backoff=0.0)):
        mgr = None if retry is None else \
            R.RecoveryManager(retry=R.RetryPolicy(**retry))
        comps, _ = serve(pkg, agent, stream, recovery=mgr,
                         cluster=ClusterModel(**TRAP_CAP),
                         world_=trap_world())
        out.append((comp_key(comps[0]), [sorted(s.covered) for s in
                                         comps[0].result.stages[:1]],
                    None if mgr is None else mgr.stats.as_dict()))
    return out


def test_oom_fallback_replan_matches_reference():
    """No recovery: the trap OOMs; a blind retry re-OOMs; the fallback
    replans around the blown (ci x mi) join and recovers."""
    ref, port = both(oom_ladder)
    assert port == ref
    none, blind, fallback = port
    assert none[0][8] and none[0][7] == TRAP_CAP["timeout"]
    assert blind[0][8] and blind[0][10] == 2
    assert not fallback[0][8] and fallback[2]["n_replanned"] == 1
    assert fallback[1] and fallback[1][0] != ["ci", "mi"]


# ---------------------------------------------------------------- hedging
class TinyPredictor:
    def predict_query(self, query):
        return 0.05


class HonestPredictor:
    def predict_query(self, query):
        return 1e4


def hedge_runs(pkg):
    R = P(pkg, "serve.recover")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, *[fast_query(i) for i in range(3)],
                           max_steps=3)
    stream = arrivals([(0.0, q, 5)] + [(0.01 * (i + 1), fast_query(i), i + 1)
                                        for i in range(3)])
    out = []
    for n_lanes, hedge in ((3, None), (3, TinyPredictor()),
                           (1, TinyPredictor()), (2, HonestPredictor())):
        mgr = R.RecoveryManager(
            injector=R.ScriptedFaults(slow={(0, 1): 40.0}),
            hedge=None if hedge is None else
            R.HedgePolicy(factor=3.0, predictor=hedge))
        comps, sched = serve(pkg, agent, stream if n_lanes == 3
                             else stream[:1], recovery=mgr, n_lanes=n_lanes)
        out.append(([comp_key(c) for c in comps], mgr.stats.as_dict(),
                    [lane.free_at for lane in sched.lanes]))
    return out


def test_hedge_race_and_no_hedge_match_reference():
    ref, port = both(hedge_runs)
    assert port == ref
    (slow, _, _), (race, stats, free_at), (one, s1, _), (honest, s2, _) = port
    c = race[0]
    assert c[12] and not c[8] and stats["n_hedge_wins"] == 1
    assert c[5] < slow[0][5] and stats["n_hedge_cancelled"] == 1
    assert all(t <= c[5] for lane, t in enumerate(free_at) if lane != c[6])
    assert s1["n_hedges"] == 0 and s2["n_hedges"] == 0


# ---------------------------------------------------------------- breaker
def breaker_run(pkg, tmp_path, *, sabotage):
    """tests/test_recover.py's breaker scenario: a seeded agent committed
    as step 1, perturbed (+1 on every actor leaf) and committed as step 2
    after seq 7; with `sabotage` every later query fails on every stage."""
    R = P(pkg, "serve.recover")
    qs = [fast_query(i) for i in range(6 if sabotage else 4)]
    meta = meta_for(pkg, qs)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    agent = P(pkg, "core.agent").AqoraAgent(
        meta, P(pkg, "core.agent").AgentConfig(max_steps=2), seed=0, **kw)
    store = P(pkg, "learn.policy_store").PolicyStore(
        tmp_path / pkg, probe=[], mode="gate")
    store.commit(agent, 1)
    incumbent = actor_leaves(pkg, agent)
    n = 16 if sabotage else 10
    faults = R.ScriptedFaults(stage={(s, 1, k): "transient"
                                     for s in range(8, n) for k in range(6)}
                              if sabotage else {})
    brk = R.PolicyBreaker(store, agent, window=8, min_post=4,
                          **({"cooldown": 5} if sabotage else {}))
    mgr = R.RecoveryManager(injector=faults, breaker=brk)
    db, est = world(pkg)
    sched = P(pkg, "serve.scheduler").LaneScheduler(
        db, est, agent, n_lanes=1 if sabotage else 2, recovery=mgr)

    def swapper(comp):
        if sabotage and comp.seq == 7 and store.serving_step == 1:
            perturb(pkg, agent)
            store.commit(agent, 2)
    sched.on_complete.insert(0, swapper)
    spacing = 0.3 if sabotage else 0.2
    comps = sched.run(of(pkg, arrivals(
        [(spacing * i, qs[i % len(qs)], i + 1) for i in range(n)])))
    return ([comp_key(c) for c in comps], brk.trips, store.serving_step,
            store.mode, mgr.stats.as_dict()), incumbent, agent


def actor_leaves(pkg, agent):
    if pkg == "repro":
        import jax
        return [np.array(x) for x in jax.tree_util.tree_leaves(agent.actor)]
    return {k: v.detach().clone() for k, v in agent.actor.state_dict().items()}


def perturb(pkg, agent):
    if pkg == "repro":
        import jax
        agent.actor = jax.tree_util.tree_map(lambda x: x + 1.0, agent.actor)
    else:
        with torch.no_grad():
            for p in agent.actor.parameters():
                p.add_(1.0)


def test_breaker_trip_restores_the_incumbent_exactly(tmp_path):
    (ref, _, _), (port, incumbent, agent) = [
        breaker_run(pkg, tmp_path, sabotage=True) for pkg in PKGS]
    assert port == ref
    comps, trips, serving_step, mode, _ = port
    assert len(comps) == 16 and len(trips) == 1
    _, bad_step, restored, reason = trips[0]
    assert (bad_step, restored, serving_step, mode) == (2, 1, 1, "gate")
    assert "failure rate" in reason
    after = agent.actor.state_dict()
    assert set(after) == set(incumbent)
    assert all(torch.equal(after[k], v) for k, v in incumbent.items())


def test_breaker_stays_quiet_like_reference(tmp_path):
    ref, port = [breaker_run(pkg, tmp_path, sabotage=False)[0]
                 for pkg in PKGS]
    assert port == ref
    comps, trips, serving_step, mode, _ = port
    assert len(comps) == 10 and not trips
    assert (serving_step, mode) == (1, "gate")


# ------------------------------------------------------- service + learn
def service_breakdown(pkg):
    R = P(pkg, "serve.recover")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, *[fast_query(i) for i in range(4)],
                           max_steps=2)
    db, est = world(pkg)
    faults = R.ScriptedFaults(stage={(0, 1, 4): "transient",
                                     (2, 1, 0): "crash", (2, 2, 0): "crash",
                                     (2, 3, 0): "crash"})
    mgr = R.RecoveryManager(injector=faults,
                            retry=R.RetryPolicy(max_attempts=3, backoff=0.0))
    harv = P(pkg, "learn.harvest").TrajectoryHarvester()
    svc = P(pkg, "serve.service").QueryService(
        db, agent, est=est, n_lanes=2, recovery=mgr, hooks=[harv])
    comps, stats = svc.run(of(pkg, arrivals(
        [(0.0, q, 5)] + [(0.05 * i, fast_query(i % 4), i + 1)
                         for i in range(1, 5)])))
    d = stats.as_dict()
    d.pop("hook_seconds")                        # host wall time
    return ([comp_key(c) for c in comps], d, mgr.stats.as_dict(),
            harv.n_seen, sorted(e.seq for e in harv.replay.all()))


def test_service_failure_breakdown_matches_reference():
    ref, port = both(service_breakdown)
    assert port == ref
    _, d, _, n_seen, seqs = port
    assert (d["n_completed"], d["n_recovered"], d["n_retried"]) == (5, 1, 2)
    assert d["attempts_total"] == 8 and d["failure_kinds"] == {"crash": 1}
    assert n_seen == 5 and len(set(seqs)) == len(seqs)


def replay_tagging(pkg):
    R = P(pkg, "serve.recover")
    q = mi_join_query()
    agent = noop_agent_for(pkg, q, max_steps=2)
    mgr = R.RecoveryManager(
        injector=R.ScriptedFaults(stage={(0, 1, 4): "transient"}),
        retry=R.RetryPolicy(max_attempts=2, backoff=0.0))
    db, est = world(pkg)
    sched = P(pkg, "serve.scheduler").LaneScheduler(db, est, agent,
                                                    n_lanes=1, recovery=mgr)
    rb = P(pkg, "learn.replay").ReplayBuffer()
    harv = P(pkg, "learn.harvest").TrajectoryHarvester(rb)
    harv.attach(sched)
    comps = sched.run(of(pkg, arrivals([(0.0, q, 5)])))
    return ([comp_key(c) for c in comps], harv.n_seen, harv.n_harvested,
            harv.n_retried, [(e.seq, e.attempts, e.recovered)
                             for e in rb.all()])


def test_replay_tagging_matches_reference():
    ref, port = both(replay_tagging)
    assert port == ref
    comps, n_seen, n_harvested, n_retried, exps = port
    assert comps[0][10] == 2 and comps[0][11] and n_seen == 1
    assert len(exps) == n_harvested <= 1
    assert all(e[1:] == (2, True) for e in exps)
