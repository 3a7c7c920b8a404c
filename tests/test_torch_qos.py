"""The port's QoS admission plane against the reference's, on the CPU.

The latency predictor (the one module of the plane written in PyTorch)
from a seed and warm-started from a critic, its fits and its refit from
a replay buffer, each held to the reference's `LatencyPredictor` on the
same inputs; then the reference's two-tenant QoS scenario (a weighted
gold tenant with a 40 s SLO, a rate-limited bulk tenant, one hopeless
straggler) served by both packages, with the reference's fixed
predictor and with the warm-started one; then the reference's EDF and
degraded-budget checks on the port. Tolerances are stated at each check.

Identical admissions only mean something while no prediction sits on a
rung of the degradation ladder (severity 1, 2 or 4), so the warm-started
scenario also asserts each prediction's smallest relative distance from
a rung.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenarios import FixedPredictor, fast_subset  # noqa: E402
from scenarios import qos_setup as j_qos_setup  # noqa: E402
from scenarios import qos_stream as j_qos_stream  # noqa: E402
from scenarios import straggler_query as j_straggler  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import agent_state as jagent_state  # noqa: E402
from repro.checkpoint import install_agent_state as jinstall  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro.serve.qos import LatencyPredictor as JPredictor  # noqa: E402
from repro.serve.qos import encode_query as j_encode_query  # noqa: E402
from repro.serve.service import QueryService as JService  # noqa: E402
from repro.sql import datagen as j_datagen  # noqa: E402
from repro.sql.cbo import Estimator as JEstimator  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (agent_state_from_numpy,  # noqa: E402
                                    install_agent_state,
                                    load_reference_checkpoint)
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.learn import TrajectoryHarvester  # noqa: E402
from repro_torch.serve.driver import (TenantTraffic,  # noqa: E402
                                      multi_tenant_stream)
from repro_torch.serve.qos import (DegradationLadder,  # noqa: E402
                                   LatencyPredictor, QoSAdmission,
                                   TenantRegistry, TenantSpec, encode_query)
from repro_torch.serve.scheduler import Arrival, LaneScheduler  # noqa: E402
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402
from repro_torch.sql.query import JoinCond, Query, Relation  # noqa: E402

STEP = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "aqora_ckpt" / "step_00000018"
RUNGS = (1.0, 2.0, 4.0)                  # DegradationLadder()'s ceilings


# ------------------------------------------------- the port's scenarios
def fresh_db():
    return datagen.make_job_like(scale=0.06, seed=0)


def straggler_query():
    """scenarios.straggler_query in the port's query classes."""
    return Query("straggler",
                 (Relation("ci", "cast_info", ()),
                  Relation("mi", "movie_info", ()),
                  Relation("mk", "movie_keyword", ())),
                 (JoinCond("ci", "movie_id", "mi", "movie_id"),
                  JoinCond("ci", "movie_id", "mk", "movie_id")))


def qos_setup(predictor):
    """scenarios.qos_setup with the port's classes and `predictor`."""
    reg = TenantRegistry([
        TenantSpec("gold", weight=2.0, slo=40.0, cache_bytes=8 << 20),
        TenantSpec("bulk", weight=1.0, rate=1.5, burst=2, slo=300.0)])
    return reg, QoSAdmission(reg, predictor=predictor,
                             ladder=DegradationLadder())


def qos_stream(wl, seed=31):
    """scenarios.qos_stream over the port's workload and stream builders."""
    fast = fast_subset(wl)
    stream = multi_tenant_stream([
        TenantTraffic("gold", fast[:4], rate=3.0, n_queries=10, slo=40.0,
                      seed=seed),
        TenantTraffic("bulk", fast[4:8] or fast, rate=3.0, n_queries=10,
                      slo=300.0, seed=seed + 1)])
    for i, a in enumerate(stream):
        if i == 4:
            a.query, a.tenant = straggler_query(), "gold"
            a.deadline = a.t + 40.0
    return stream


@pytest.fixture(scope="module")
def wl():
    """The port's copy of conftest's `job_workload`."""
    return workloads.make_workload("job", n_train=24, n_test_per_template=1,
                                   seed=7)


@pytest.fixture(scope="module")
def port_fresh(wl):
    return AqoraAgent(WorkloadMeta.from_workload(wl), AgentConfig(), seed=0,
                      device="cpu")


@pytest.fixture(scope="module")
def step18(wl, job_workload):
    """The reference agent and the port's (CPU) from step 18's state."""
    ref = JAgent(JMeta.from_workload(job_workload), JAgentConfig(), seed=0)
    state, _, _ = JCheckpointer(STEP.parent).restore(jagent_state(ref),
                                                     step=18)
    jinstall(ref, state)
    port = AqoraAgent(WorkloadMeta.from_workload(wl), AgentConfig(), seed=0,
                      device="cpu")
    install_agent_state(port, agent_state_from_numpy(
        load_reference_checkpoint(STEP)))
    return ref, port


def flat(params):
    return {k: v.detach().numpy().copy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.flatten(params)}


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# ----------------------------------------------------------- predictor
def test_predictor_device_and_encoder(wl, port_fresh, monkeypatch):
    """Without a device and without an agent it asks for CUDA and raises
    without it; `device="cpu"` is the plain path; with an agent it lives
    on the agent's device; every encoder of the reference builds, and an
    unknown one raises."""
    meta = WorkloadMeta.from_workload(wl)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LatencyPredictor(meta)
    assert LatencyPredictor(meta, device="cpu").device.type == "cpu"
    assert LatencyPredictor(meta, agent=port_fresh).device.type == "cpu"
    for net in ("lstm", "fcnn", "queryformer"):
        pred = LatencyPredictor(meta, net=net, device="cpu")
        assert type(pred.model.enc).__name__.lower() == pred.net == net
    with pytest.raises(ValueError, match="gru"):
        LatencyPredictor(meta, net="gru", device="cpu")


def test_seeded_predictor_matches_reference_initialisation(wl,
                                                          job_workload):
    """LatencyPredictor(seed=3): every leaf equal to the reference's (both
    draw from split(PRNGKey(3), 2)), the AdamW state zero."""
    got = LatencyPredictor(WorkloadMeta.from_workload(wl), seed=3,
                           device="cpu")
    want = JPredictor(JMeta.from_workload(job_workload), seed=3)
    a, b = flat(got.params), flat(want.params)
    assert set(a) == set(b) and len(a) == 16
    for name, w in b.items():
        assert a[name].dtype == w.dtype and a[name].shape == w.shape
        np.testing.assert_array_equal(a[name], w, err_msg=name)
    assert int(got.opt["step"]) == 0
    assert not any(flat(got.opt["m"])[k].any() for k in a)


def test_warm_start_prediction_matches_critic_and_reference(wl, step18,
                                                            job_workload):
    """Warm-started from the step-18 critic: predictions equal
    max(0, -v)^2 of the port's critic and the reference predictor's, to
    1e-5 relative; the encodings are the reference's exactly."""
    ref, port = step18
    pred = LatencyPredictor(port.meta, agent=port)
    jpred = JPredictor(ref.meta, agent=ref)
    for q, jq in zip(wl.test[:6], job_workload.test[:6]):
        enc, jenc = encode_query(q, port.meta), j_encode_query(jq, ref.meta)
        for x, y in zip(enc, jenc):
            np.testing.assert_array_equal(x, y)
        p = pred.predict_enc(enc)
        assert p == pytest.approx(max(0.0, -port.value(enc)) ** 2, rel=1e-5)
        assert p == pytest.approx(jpred.predict_enc(jenc), rel=1e-5)
        assert p > 0.0


def _force(pred, jpred):
    """Put the reference predictor's params and AdamW state on the
    port's."""
    with torch.no_grad():
        tree.tree_map(lambda p, x: p.copy_(torch.from_numpy(np.array(x))),
                      pred.params, jpred.params)
    pred.opt = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                             jpred.opt)


def test_predictor_fit_matches_reference(wl, job_workload):
    """The reference's slow-vs-fast fit sequence (seed 3, lr 5e-3; 13
    `fit` calls, 25 AdamW steps), held two ways.

    In lockstep (each call starts from the reference's params and AdamW
    state): every call's leaves within 1e-4 of the reference's, and its
    loss within 1e-5 of the reference's relative to max(loss, 1). Below
    a loss of 1 the bound is absolute: this loss is a mean of squared
    residuals of outputs near -sqrt(300) = -17.3, whose last bit
    (1.9e-6) moves a loss of 0.07 by 2e-5 of itself.

    Free-running (the reference test's own sequence on each side): the
    first five losses within 1e-5 relative; after them the two sequences
    part, since AdamW turns the last-bit differences of gradient
    components near 1e-7 into steps that differ by 1e-5, and this fit at
    lr 5e-3 amplifies them (losses apart by 6e-5 at call 8, 0.13 at call
    13). So on the port alone: the reference test's checks (the loss
    falls, the straggler is predicted > 10x the fast query, the memo is
    fenced by the fit generation)."""
    meta, jmeta = WorkloadMeta.from_workload(wl), JMeta.from_workload(
        job_workload)
    fast = encode_query(wl.test[0], meta)
    slow = encode_query(straggler_query(), meta)
    jfast = j_encode_query(job_workload.test[0], jmeta)
    jslow = j_encode_query(j_straggler(), jmeta)
    lats = [1.0, 300.0] * 8

    def sequence(pred, jpred, lockstep):
        out = []
        for i in range(13):
            if lockstep:
                _force(pred, jpred)
            epochs = 1 if i == 0 else 2
            out.append((pred.fit([fast, slow] * 8, lats, batch_size=8,
                                 epochs=epochs),
                        jpred.fit([jfast, jslow] * 8, lats, batch_size=8,
                                  epochs=epochs)))
            if lockstep:
                a, b = flat(pred.params), flat(jpred.params)
                for name, w in b.items():
                    np.testing.assert_allclose(a[name], w, atol=1e-4,
                                               rtol=0, err_msg=(i, name))
        return out

    def predictors():
        return (LatencyPredictor(meta, seed=3, lr=5e-3, device="cpu"),
                JPredictor(jmeta, seed=3, lr=5e-3))

    pred, jpred = predictors()
    for i, (got, want) in enumerate(sequence(pred, jpred, lockstep=True)):
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (i, got, want)
    assert pred.stats() == jpred.stats()

    pred, jpred = predictors()
    losses = sequence(pred, jpred, lockstep=False)
    for i, (got, want) in enumerate(losses[:5]):
        assert rel(got, want) <= 1e-5, (i, got, want)
    assert losses[-1][0] < losses[0][0]
    assert pred.predict_enc(slow) > 10 * pred.predict_enc(fast)
    q = wl.test[0]
    before = pred.predict_query(q)
    pred.fit([fast], [200.0], batch_size=4, epochs=4)
    assert pred.predict_query(q) != before


@pytest.fixture(scope="module")
def replay(wl, port_fresh):
    """A replay buffer harvested from 12 exploring queries on the port."""
    db = datagen.make_job_like(scale=0.05, seed=0)
    harv = TrajectoryHarvester()
    svc = QueryService(db, port_fresh, est=Estimator(db, db.stats),
                       n_lanes=2, policy="async", explore=True, hooks=[harv])
    svc.run([Arrival(0.5 * i, query=wl.train[i], seed=40 + i)
             for i in range(12)])
    assert len(harv.replay) >= 8
    return harv.replay


def test_fit_from_replay_matches_reference(step18, replay):
    """Both warm-started predictors refit from the same buffer with the
    same rng (64 samples, batch 16, 2 epochs): the reference's loss to
    1e-5 relative, the same refit log and stats; the serving critic the
    port's predictor was copied from is left unchanged."""
    ref, port = step18
    critic = flat(port.critic.state_dict())
    pred = LatencyPredictor(port.meta, agent=port)
    jpred = JPredictor(ref.meta, agent=ref)
    got = pred.refit_on_drift(replay, np.random.default_rng(0),
                              trigger="test")
    want = jpred.refit_on_drift(replay, np.random.default_rng(0),
                                trigger="test")
    assert rel(got, want) <= 1e-5, (got, want)
    assert pred.refit_log == jpred.refit_log
    assert pred.stats() == jpred.stats() and pred.n_fit_steps > 0
    after = flat(port.critic.state_dict())
    for name, v in critic.items():
        np.testing.assert_array_equal(after[name], v, err_msg=name)
    moved = flat(pred.model.state_dict())
    assert any(not np.array_equal(moved[k], critic[k]) for k in critic)


# --------------------------------------------------------- the QoS plane
def _rows(comps, rejections, adm, stats):
    d = stats.as_dict()
    d.pop("hook_seconds")               # host wall time: not virtual-clock
    return ([(c.seq, c.tenant, c.admit_t, c.finish_t, c.hook_budget,
              c.degraded, c.lane, tuple(c.traj.actions)) for c in comps],
            [(r.seq, r.reject_t, r.reason) for r in rejections],
            {k: v for k, v in adm.stats().items() if k != "predictor"}, d)


@pytest.mark.parametrize("predictor", ["fixed", "warm"])
def test_qos_scenario_matches_reference(wl, job_workload, agent, port_fresh,
                                        step18, predictor):
    """The reference's `qos_setup`/`qos_stream` on 2 EDF lanes, served by
    both packages: admissions, deferrals, rejections, degradations, hook
    budgets and completions identical. With "fixed" the reference's stub
    predictor and fresh seed-0 agents; with "warm" step-18 agents and a
    predictor warm-started from each one's critic, whose predictions agree
    to 1e-5 relative, each at least 1e-3 (relative) from a rung."""
    if predictor == "fixed":
        serving, jserving = port_fresh, agent
        pred, jpred = FixedPredictor(), FixedPredictor()
    else:
        jserving, serving = step18
        pred = LatencyPredictor(serving.meta, agent=serving)
        jpred = JPredictor(jserving.meta, agent=jserving)
    severities = []
    db = fresh_db()
    reg, adm = qos_setup(pred)
    choose = adm.ladder.choose

    def noting_choose(predicted, slack, memo_hit=False):
        severities.append(predicted / slack)
        return choose(predicted, slack, memo_hit=memo_hit)
    adm.ladder.choose = noting_choose
    svc = QueryService(db, serving, est=Estimator(db, db.stats), n_lanes=2,
                       policy="edf", tenants=reg, admission=adm)
    comps, stats = svc.run(qos_stream(wl))
    got = _rows(comps, svc.scheduler.rejections, adm, stats)

    jdb = j_datagen.make_job_like(scale=0.06, seed=0)
    jreg, jadm = j_qos_setup()
    jadm.predictor = jpred
    jsvc = JService(jdb, jserving, est=JEstimator(jdb, jdb.stats),
                    n_lanes=2, policy="edf", tenants=jreg, admission=jadm)
    jcomps, jstats = jsvc.run(j_qos_stream(job_workload))
    want = _rows(jcomps, jsvc.scheduler.rejections, jadm, jstats)
    assert got == want
    assert len(got[0]) + len(got[1]) == 20
    if predictor == "fixed":
        assert len(got[1]) == 1               # the straggler is rejected
        assert got[2]["deferred"] > 0         # bulk hit its rate limit
        return
    assert pred.stats() == jpred.stats() and severities
    by_name = {q.name: p for q, p in pred._pred_memo.items()}
    jby_name = {q.name: p for q, p in jpred._pred_memo.items()}
    assert set(by_name) == set(jby_name)
    for name, p in by_name.items():
        assert rel(p, jby_name[name]) <= 1e-5, name
    distance = min(abs(s - r) / r for s in severities for r in RUNGS)
    assert distance > 1e-3, distance


def test_edf_reorders_by_deadline(wl, port_fresh):
    fast = fast_subset(wl)

    def order(policy):
        db = fresh_db()
        sched = LaneScheduler(db, Estimator(db, db.stats), port_fresh,
                              n_lanes=1, policy=policy)
        comps = sched.run([Arrival(0.0, query=fast[i], seed=i, deadline=dl)
                           for i, dl in enumerate((30.0, 10.0, 20.0))])
        return [c.seq for c in sorted(comps, key=lambda c: c.admit_t)]

    assert order("async") == [0, 1, 2]          # FCFS: stream order
    assert order("edf") == [1, 2, 0]            # earliest deadline first


def test_degraded_budget_caps_hook_steps(port_fresh):
    """An admission-assigned hook budget really limits act_batch
    decisions: budget 1 -> at most one action, budget 0 -> none."""
    for slo, budget in ((200.0, 1), (120.0, 0)):   # severity 1.5, 2.5
        reg = TenantRegistry([TenantSpec("t", slo=slo)])
        adm = QoSAdmission(reg, predictor=FixedPredictor(),
                           ladder=DegradationLadder())
        db = fresh_db()
        sched = LaneScheduler(db, Estimator(db, db.stats), port_fresh,
                              n_lanes=1, policy="edf", admission=adm)
        comps = sched.run([Arrival(0.0, query=straggler_query(), seed=0,
                                   tenant="t")])
        assert len(comps) == 1
        c = comps[0]
        assert c.degraded and c.hook_budget == budget
        assert len(c.traj.actions) <= budget

