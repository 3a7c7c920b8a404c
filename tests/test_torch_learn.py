"""The port's lifelong-learning loop against the reference's, on the CPU.

Both packages build the same JOB-like db (scale 0.05, seed 0) and the
`job_workload` (n_train 24, seed 7), and fresh agents from the same seed,
which the port draws bit-equal to the reference's. Then: the harvester
on each package's scheduler, replay sampling, a PPO update on harvested
trajectories, the whole online loop (harvester, learner, curriculum,
policy-store gate) serving with exploration, the gate's verdicts, policy
stores crossing between the packages, `Checkpointer.next_step` and
`install_agent_state(copy=True)`. Tolerances are stated at each check.

Exact action equality under exploration only means something while no
Gumbel-perturbed score is a near tie, so the online test also asserts the
smallest top-1/top-2 margin of the scores each decision took its action
from.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import agent_state as jagent_state  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro.learn import AdaptiveCurriculum as JCurriculum  # noqa: E402
from repro.learn import PolicyStore as JPolicyStore  # noqa: E402
from repro.learn import ReplayBuffer as JReplayBuffer  # noqa: E402
from repro.learn import TrajectoryHarvester as JHarvester  # noqa: E402
from repro.learn import make_online_loop as j_online_loop  # noqa: E402
from repro.serve.scheduler import Arrival as JArrival  # noqa: E402
from repro.serve.scheduler import LaneScheduler as JScheduler  # noqa: E402
from repro.serve.service import QueryService as JService  # noqa: E402
from repro.sql import datagen as j_datagen  # noqa: E402
from repro.sql.cbo import Estimator as JEstimator  # noqa: E402
from repro.sql.cluster import ClusterModel as JCluster  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, agent_state,  # noqa: E402
                                    install_agent_state, params_finite)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.core.rollout import rollout  # noqa: E402
from repro_torch.learn import (AdaptiveCurriculum, PolicyStore,  # noqa: E402
                               ReplayBuffer, TrajectoryHarvester,
                               make_online_loop)
from repro_torch.serve.scheduler import Arrival, LaneScheduler  # noqa: E402
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402
from repro_torch.sql.cluster import ClusterModel  # noqa: E402

SEEDS = [101, 102, 103, 104, 105]


@pytest.fixture(scope="module")
def wl():
    """The port's copy of conftest's `job_workload`."""
    return workloads.make_workload("job", n_train=24, n_test_per_template=1,
                                   seed=7)


def port_agent(wl, seed):
    return AqoraAgent(WorkloadMeta.from_workload(wl), AgentConfig(),
                      seed=seed, device="cpu")


def ref_agent(job_workload, seed):
    return JAgent(JMeta.from_workload(job_workload), JAgentConfig(),
                  seed=seed)


def port_leaves(agent):
    return {k: v.detach().numpy().copy()
            for k, v in tree.flatten(agent_state(agent))}


def ref_leaves(agent):
    return {k: np.asarray(v) for k, v in tree.flatten(jagent_state(agent))}


def assert_leaves_close(got, want, atol):
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=0,
                                   err_msg=name)


def record_margins(agent, out):
    """Wrap the port agent's `act_batch` and `act` so that each live
    decision appends the top-1/top-2 margin of the scores it takes its
    action from: the Gumbel-perturbed logits when exploring (as
    `prng.categorical` draws), the masked logits when greedy."""
    inner_batch, inner_act = agent.act_batch, agent.act

    def logits(feat, left, right, mask, amask):
        with torch.inference_mode():
            lg = agent.actor(*(torch.from_numpy(np.ascontiguousarray(x))
                               for x in (feat, left, right, mask)))
            return lg.masked_fill(~(torch.from_numpy(np.asarray(amask)) > 0),
                                  -1e9)

    def note(scores, live):
        top = scores.topk(2, dim=-1).values
        out.extend((top[:, 0] - top[:, 1])[torch.from_numpy(live)].tolist())

    def act_batch(feat, left, right, mask, amask, keys, explore=True):
        s = logits(feat, left, right, mask, amask)
        if explore:
            u = prng.gumbel_uniforms(prng.split(keys)[:, 1], s.shape[-1])
            s = -torch.log(-torch.log(torch.from_numpy(u))) + s
        note(s, np.asarray(mask).sum(axis=1) > 0)
        return inner_batch(feat, left, right, mask, amask, keys,
                           explore=explore)

    def act(enc, amask, explore=True):
        if not explore:
            note(logits(*(np.asarray(x)[None] for x in enc),
                        np.asarray(amask)[None]), np.array([True]))
        return inner_act(enc, amask, explore=explore)

    agent.act_batch, agent.act = act_batch, act


# ------------------------------------------------- harvest and replay
def _harvest(sched, harv, arrival, qs):
    harv.attach(sched)
    sched.run([arrival(0.4 * i, query=q, seed=s)
               for i, (q, s) in enumerate(zip(qs, SEEDS))])
    return harv


@pytest.fixture(scope="module")
def harvested(wl, job_workload):
    """Five test queries served with exploration on 2 async lanes by each
    package from fresh seed-11 agents, harvested."""
    db = datagen.make_job_like(scale=0.05, seed=0)
    port = port_agent(wl, 11)
    hp = _harvest(LaneScheduler(db, Estimator(db, db.stats), port,
                                n_lanes=2, explore=True, policy="async"),
                  TrajectoryHarvester(), Arrival, wl.test[:5])
    jdb = j_datagen.make_job_like(scale=0.05, seed=0)
    ref = ref_agent(job_workload, 11)
    hr = _harvest(JScheduler(jdb, JEstimator(jdb, jdb.stats), ref,
                             n_lanes=2, explore=True, policy="async"),
                  JHarvester(), JArrival, job_workload.test[:5])
    return hp, hr, port, ref


def test_harvester_yields_the_reference_experiences(harvested):
    """Per experience: seq, query, actions, rewards, latency, failure,
    finish time, tables and data versions identical; logps to 1e-5."""
    hp, hr, _, _ = harvested
    assert hp.stats() == hr.stats()
    got, want = hp.replay.all(), hr.replay.all()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.seq, g.query_name, g.latency, g.failed, g.finish_t,
                g.tables, g.versions, g.harvest_idx) == \
            (w.seq, w.query_name, w.latency, w.failed, w.finish_t,
             w.tables, w.versions, w.harvest_idx)
        assert g.traj.actions == w.traj.actions
        assert g.traj.rewards == w.traj.rewards
        np.testing.assert_allclose(g.traj.logps, w.traj.logps, atol=1e-5)


def test_replay_sampling_matches_reference(harvested):
    """The same rng state draws the same experiences, priorities equal."""
    hp, hr, _, _ = harvested
    for versions in ({}, {"title": 1}):
        np.testing.assert_array_equal(hp.replay.priorities(versions),
                                      hr.replay.priorities(versions))
        for seed in (0, 7):
            got = hp.replay.sample(3, np.random.default_rng(seed), versions)
            want = hr.replay.sample(3, np.random.default_rng(seed), versions)
            assert [e.seq for e in got] == [e.seq for e in want]
    # a bounded buffer evicts and samples as the reference's
    rp, rr = ReplayBuffer(capacity=3), JReplayBuffer(capacity=3)
    for g, w in zip(hp.replay.all() * 2, hr.replay.all() * 2):
        rp.add(g)
        rr.add(w)
    assert rp.stats() == rr.stats()
    assert [e.seq for e in rp.sample(2, np.random.default_rng(3))] == \
        [e.seq for e in rr.sample(2, np.random.default_rng(3))]


def test_harvested_trajectories_match_offline_gradients(harvested, wl):
    """The reference's harvest == offline test, port against reference:
    one `ppo_update_batch` on each package's harvested trajectories from
    identical fresh state gives every leaf within 1e-5 of the reference's
    (the tolerance of test_ppo_update_batch_matches_reference); and the
    port's harvested trajectories equal its own serial seeded rollouts,
    whose update gives the same leaves (1e-6 rel, 1e-7 abs, as the
    reference test holds its own)."""
    hp, hr, port_src, ref_src = harvested
    port, ref = port_src.clone(seed=11), ref_src.clone(seed=11)
    exps_p, exps_r = hp.replay.all(), hr.replay.all()
    port.ppo_update_batch([e.traj for e in exps_p])
    ref.ppo_update_batch([e.traj for e in exps_r])
    assert_leaves_close(port_leaves(port), ref_leaves(ref), atol=1e-5)

    db = datagen.make_job_like(scale=0.05, seed=0)
    est = Estimator(db, db.stats)
    offline_agent = port_agent(wl, 11)
    offline = [rollout(db, q, est, offline_agent, stage=3, explore=True,
                       key=s) for q, s in zip(wl.test[:5], SEEDS)]
    for e, t in zip(exps_p, [t for t in offline if t.actions]):
        assert e.traj.actions == t.actions and e.traj.rewards == t.rewards
    offline_agent.ppo_update_batch(offline)
    a, b = port_leaves(port), port_leaves(offline_agent)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


# ------------------------------------------------------ the online loop
def _online_stream(wl, arrival):
    qs = wl.train[:6]
    rng = np.random.default_rng(9)
    return [arrival(0.5 * i, query=qs[i % len(qs)],
                    seed=int(rng.integers(2 ** 31)))
            for i in range(12)]


def test_online_serving_with_learner_on_matches_reference(
        wl, job_workload, tmp_path):
    """The reference's bit-reproducibility scenario (fresh seed-0 agents,
    a 12-query exploring stream on 2 lanes, a PPO update every 3
    completions, a gate every 2 updates, an adaptive curriculum) served
    by both packages: actions, finish times, latencies, learner stats
    (without host_seconds), promotions and gate verdicts and scores
    equal; logps within 1e-4; the serving agents' final leaves within
    1e-5; every decision's top-1/top-2 margin above 1e-4."""
    def run(pkg):
        if pkg == "port":
            db = datagen.make_job_like(scale=0.05, seed=0)
            est, agent = Estimator(db, db.stats), port_agent(wl, 0)
            store = PolicyStore(tmp_path / "port", wl.test[:2])
            h, l = make_online_loop(
                agent, store=store, update_every=3, sample_size=3,
                gate_every=2, seed=5,
                curriculum=AdaptiveCurriculum(window=4, min_dwell=4))
            record_margins(agent, margins)
            record_margins(l.agent, margins)
            svc = QueryService(db, agent, est=est, n_lanes=2,
                               policy="async", explore=True, hooks=[h, l])
            stream = _online_stream(wl, Arrival)
        else:
            db = j_datagen.make_job_like(scale=0.05, seed=0)
            est, agent = JEstimator(db, db.stats), ref_agent(job_workload, 0)
            store = JPolicyStore(tmp_path / "ref", job_workload.test[:2])
            h, l = j_online_loop(
                agent, store=store, update_every=3, sample_size=3,
                gate_every=2, seed=5,
                curriculum=JCurriculum(window=4, min_dwell=4))
            svc = JService(db, agent, est=est, n_lanes=2, policy="async",
                           explore=True, hooks=[h, l])
            stream = _online_stream(job_workload, JArrival)
        comps, _ = svc.run(stream)
        return comps, l, agent

    margins = []
    cp, lp, ap = run("port")
    cr, lr, ar = run("ref")
    assert min(margins) > 1e-4, (
        f"a decision is a near tie (margin {min(margins)}): exact action "
        "equality with the reference is not meaningful here")
    assert len(cp) == len(cr) == 12
    for a, b in zip(cp, cr):
        assert (a.seq, a.traj.actions, a.finish_t, a.result.latency,
                a.result.failed, a.lane) == \
            (b.seq, b.traj.actions, b.finish_t, b.result.latency,
             b.result.failed, b.lane), a.seq
        np.testing.assert_allclose(a.traj.logps, b.traj.logps, atol=1e-4)
    sp, sr = lp.stats.as_dict(), lr.stats.as_dict()
    sp.pop("host_seconds"), sr.pop("host_seconds")
    assert sp == sr and sp["updates"] > 0 and sp["gates"] > 0
    assert lp.curriculum.stats() == lr.curriculum.stats()
    assert lp.curriculum.promotions
    keys = ("step", "accepted", "swapped", "reason", "candidate_score",
            "incumbent_score")
    assert [tuple(g[k] for k in keys) for g in lp.store.gate_log] == \
        [tuple(g[k] for k in keys) for g in lr.store.gate_log]
    assert lp.store.stats() == lr.store.stats()
    assert [u["n_traj"] for u in lp.update_log] == \
        [u["n_traj"] for u in lr.update_log]
    assert_leaves_close(port_leaves(ap), ref_leaves(ar), atol=1e-5)


def test_shadow_learning_serves_bit_identical_to_learning_off(wl, tmp_path):
    """A shadow-mode store evaluates candidates but never swaps, so the
    serving run with the learner on is bit-identical to learning off:
    actions, logps, finish times, lanes."""
    def serve(hooks_for):
        db = datagen.make_job_like(scale=0.05, seed=0)
        agent = port_agent(wl, 0)
        svc = QueryService(db, agent, est=Estimator(db, db.stats), n_lanes=2,
                           policy="async", explore=True,
                           hooks=hooks_for(agent))
        return svc.run(_online_stream(wl, Arrival))[0]

    learners = []

    def shadow(agent):
        h, l = make_online_loop(
            agent, store=PolicyStore(tmp_path / "shadow", wl.test[:2],
                                     mode="shadow"),
            update_every=3, sample_size=3, gate_every=2, seed=5)
        learners.append(l)
        return [h, l]

    on = serve(shadow)
    off = serve(lambda agent: [])
    stats = learners[0].stats
    assert stats.updates > 0 and stats.gates > 0 and stats.swaps == 0
    assert [(c.seq, c.traj.actions, c.traj.logps, c.finish_t, c.lane)
            for c in on] == \
        [(c.seq, c.traj.actions, c.traj.logps, c.finish_t, c.lane)
         for c in off]


# ------------------------------------------------------------- the gate
def _nan_corrupt(agent):
    with torch.no_grad():
        for p in agent.actor.parameters():
            p.mul_(float("nan"))


@pytest.fixture()
def gate_world(wl):
    db = datagen.make_job_like(scale=0.05, seed=0)
    return db, Estimator(db, db.stats), ClusterModel()


def test_gate_rejects_corrupted_candidate_and_serving_continues(
        wl, gate_world, tmp_path):
    db, est, cluster = gate_world
    serving = port_agent(wl, 0)
    store = PolicyStore(tmp_path / "ps", wl.test[:2])
    store.commit(serving, step=0)
    cand = port_agent(wl, 1)
    install_agent_state(cand, agent_state(serving))
    _nan_corrupt(cand)
    assert not params_finite(cand)
    before = port_leaves(serving)
    rec = store.evaluate_and_maybe_swap(serving, cand, db=db, est=est,
                                        cluster=cluster, step=1)
    assert not rec["accepted"] and "non-finite" in rec["reason"]
    assert store.serving_step == 0 and len(store.versions) == 1
    after = port_leaves(serving)
    for name, v in before.items():
        np.testing.assert_array_equal(after[name], v, err_msg=name)
    traj = rollout(db, wl.test[0], est, serving, stage=3, explore=False,
                   cluster=cluster)
    assert np.isfinite(traj.result.latency)


def test_gate_accepts_equal_candidate_and_shadow_never_swaps(
        wl, job_workload, gate_world, tmp_path):
    """An equal candidate passes and swaps in gate mode, never in shadow
    mode; both scores equal the reference gate's on the same probes."""
    db, est, cluster = gate_world
    serving = port_agent(wl, 0)
    cand = port_agent(wl, 1)
    install_agent_state(cand, agent_state(serving))

    shadow = PolicyStore(tmp_path / "shadow", wl.test[:2], mode="shadow")
    rec = shadow.evaluate_and_maybe_swap(serving, cand, db=db, est=est,
                                         cluster=cluster, step=1)
    assert rec["accepted"] and not rec["swapped"] and not shadow.versions

    gate = PolicyStore(tmp_path / "gate", wl.test[:2])
    rec = gate.evaluate_and_maybe_swap(serving, cand, db=db, est=est,
                                       cluster=cluster, step=1)
    assert rec["accepted"] and rec["swapped"]
    assert gate.serving_step == 1 and len(gate.versions) == 1

    jdb = j_datagen.make_job_like(scale=0.05, seed=0)
    jserving, jcand = ref_agent(job_workload, 0), ref_agent(job_workload, 0)
    want = JPolicyStore(tmp_path / "ref", job_workload.test[:2]) \
        .evaluate_and_maybe_swap(jserving, jcand, db=jdb,
                                 est=JEstimator(jdb, jdb.stats),
                                 cluster=JCluster(), step=1)
    assert (rec["candidate_score"], rec["incumbent_score"]) == \
        (want["candidate_score"], want["incumbent_score"])


def test_policy_store_rollback_restores_committed_version(wl, tmp_path):
    agent = port_agent(wl, 0)
    store = PolicyStore(tmp_path / "ps", [])
    store.commit(agent, step=0)
    committed = port_leaves(agent)
    _nan_corrupt(agent)
    assert not params_finite(agent)
    assert store.rollback(agent) == 0
    assert params_finite(agent)
    back = port_leaves(agent)
    for name, v in committed.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)


def test_policy_store_directories_cross_both_ways(wl, job_workload,
                                                  tmp_path):
    """A version the reference's store commits restores in the port's
    store (rollback), and the other way round: every leaf bit-equal. A
    commit into a directory the other package wrote takes the next free
    step."""
    ref, port = ref_agent(job_workload, 3), port_agent(wl, 0)
    assert JPolicyStore(tmp_path, []).commit(ref, step=0) == 0
    store = PolicyStore(tmp_path, [])
    assert store.rollback(port) == 0
    assert_leaves_close(port_leaves(port), ref_leaves(ref), atol=0)

    with torch.no_grad():
        for p in port.critic.parameters():
            p.add_(0.25)
    assert store.commit(port, step=0) == 1        # step 0 is on disk
    back = ref_agent(job_workload, 0)
    assert JPolicyStore(tmp_path, []).rollback(back, step=1) == 1
    assert_leaves_close(ref_leaves(back), port_leaves(port), atol=0)


# ------------------------------------------------------- checkpoint API
def test_checkpointer_next_step_skips_steps_on_disk(wl, tmp_path):
    ck = Checkpointer(tmp_path)
    assert ck.next_step() == 0 and ck.next_step(5) == 5
    state = agent_state(port_agent(wl, 0))
    for step in (0, 3):
        assert ck.save(step, state)
    assert not ck.save(3, state)                  # existing: skipped
    jck = JCheckpointer(tmp_path)
    for hint in (0, 2, 4, 9):
        assert ck.next_step(hint) == jck.next_step(hint) == max(hint, 4)
    assert ck.save(ck.next_step(), state) and ck.steps() == [0, 3, 4]


@pytest.mark.parametrize("copy", [True, False])
def test_install_agent_state_copy_shares_no_tensor(wl, copy):
    """copy=True: after the install, writing every leaf of the source
    leaves the agent as installed, and no storage is shared. Parameters
    go into the agent's own `nn.Parameter`s either way; with copy=False
    the AdamW tensors on the agent's device are taken as they are."""
    src = port_agent(wl, 1)
    tree_ = agent_state(src)
    dst = port_agent(wl, 2)
    params_before = [id(p) for p in dst.actor.parameters()]
    install_agent_state(dst, tree_, copy=copy)
    assert [id(p) for p in dst.actor.parameters()] == params_before
    installed = port_leaves(dst)
    np.testing.assert_array_equal(installed["actor/head/w1"],
                                  port_leaves(src)["actor/head/w1"])
    with torch.no_grad():
        for _, leaf in tree.flatten(tree_):
            leaf.add_(1)
    src_ptrs = {leaf.data_ptr() for _, leaf in tree.flatten(tree_)}
    dst_ptrs = {leaf.data_ptr() for _, leaf in
                tree.flatten(agent_state(dst))}
    after = port_leaves(dst)
    for name in ("actor/enc/conv1/wr", "critic/head/b2"):
        np.testing.assert_array_equal(after[name], installed[name])
    if copy:
        assert not src_ptrs & dst_ptrs
        for name, v in installed.items():
            np.testing.assert_array_equal(after[name], v, err_msg=name)
    else:
        assert dst.aopt["m"]["head"]["w1"] is tree_["aopt"]["m"]["head"]["w1"]
