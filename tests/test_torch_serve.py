"""The slice as a whole: the port's query service against the reference's.

Both packages build the JOB-like db (scale 0.12, seed 0) and the
`n_train=100` workload the step-18 checkpoint was trained on, load that
checkpoint, and serve the same open-loop stream greedily on 8 async
lanes. Per query the actions, virtual finish time, failure and lane must
be identical, and the log-probabilities agree to 1e-4. Exact action
equality only means something when no decision is a near tie, so the
test also asserts the smallest top-1/top-2 masked-logit margin.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer, agent_state  # noqa: E402
from repro.checkpoint import install_agent_state  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro.core.rollout import rollout as j_rollout  # noqa: E402
from repro.serve.driver import open_loop_stream as j_stream  # noqa: E402
from repro.serve.service import QueryService as JService  # noqa: E402
from repro.sql import datagen as j_datagen  # noqa: E402
from repro.sql import workloads as j_workloads  # noqa: E402
from repro.sql.cbo import Estimator as JEstimator  # noqa: E402
from repro_torch.checkpoint import (load_reference_checkpoint,  # noqa: E402
                                    params_from_numpy)
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.core.rollout import rollout  # noqa: E402
from repro_torch.serve.driver import open_loop_stream  # noqa: E402
from repro_torch.serve.obs import SloMonitor, Tracer  # noqa: E402
from repro_torch.serve.scheduler import Arrival, LaneScheduler  # noqa: E402
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402

CKPT_DIR = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "aqora_ckpt"
N_QUERIES = 32


@pytest.fixture(scope="module")
def port_world():
    db = datagen.make_job_like(scale=0.12, seed=0)
    wl = workloads.make_workload("job", n_train=100, n_test_per_template=1)
    agent = AqoraAgent(WorkloadMeta.from_workload(wl), AgentConfig(),
                       seed=0, device="cpu")
    agent.load_params(params_from_numpy(
        load_reference_checkpoint(CKPT_DIR / "step_00000018")))
    return db, wl, agent


@pytest.fixture(scope="module")
def reference_world():
    db = j_datagen.make_job_like(scale=0.12, seed=0)
    wl = j_workloads.make_workload("job", n_train=100, n_test_per_template=1)
    agent = JAgent(JMeta.from_workload(wl), JAgentConfig(), seed=0)
    tree, _, _ = Checkpointer(CKPT_DIR).restore(agent_state(agent), step=18)
    install_agent_state(agent, tree)
    return db, wl, agent


@pytest.fixture(scope="module")
def reference_run(reference_world):
    db, wl, agent = reference_world
    stream = j_stream(wl.test, rate=2.0, n_queries=N_QUERIES, seed=1)
    return JService(db, agent, n_lanes=8, policy="async").run(stream)


def test_port_serves_the_reference_completions(port_world, reference_run):
    db, wl, agent = port_world
    margins = []
    inner = agent.act_batch

    def margin_act_batch(feat, left, right, mask, amask, keys, explore):
        with torch.inference_mode():
            lg = agent.actor(*(torch.from_numpy(np.ascontiguousarray(x))
                               for x in (feat, left, right, mask)))
            lg = lg.masked_fill(~(torch.from_numpy(amask) > 0), -1e9)
            top = lg.topk(2, dim=-1).values
            live = torch.from_numpy(mask.sum(axis=1) > 0)
            margins.extend((top[:, 0] - top[:, 1])[live].tolist())
        return inner(feat, left, right, mask, amask, keys, explore=explore)

    agent.act_batch = margin_act_batch
    try:
        stream = open_loop_stream(wl.test, rate=2.0, n_queries=N_QUERIES,
                                  seed=1)
        comps, stats = QueryService(db, agent, n_lanes=8,
                                    policy="async").run(stream)
    finally:
        del agent.act_batch
    ref_comps, ref_stats = reference_run
    assert min(margins) > 1e-3, (
        f"a greedy decision is a near tie (margin {min(margins)}): exact "
        "action equality with the reference is not meaningful here")
    assert len(comps) == len(ref_comps) == N_QUERIES
    assert sum(len(c.traj.actions) for c in comps) > N_QUERIES
    for a, b in zip(comps, ref_comps):
        assert a.seq == b.seq
        assert a.traj.actions == b.traj.actions, a.seq
        assert a.finish_t == b.finish_t, a.seq
        assert a.result.failed == b.result.failed, a.seq
        assert a.lane == b.lane, a.seq
        np.testing.assert_allclose(a.traj.logps, b.traj.logps, atol=1e-4)
    assert stats.ticks == ref_stats.ticks
    assert stats.latency_p99 == ref_stats.latency_p99
    assert stats.mean_decide_batch == ref_stats.mean_decide_batch


def test_lockstep_serves_the_same_plans(port_world):
    db, wl, agent = port_world
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=16, seed=1)
    by = {}
    for policy in ("async", "lockstep"):
        comps, _ = QueryService(db, agent, n_lanes=8,
                                policy=policy).run(stream)
        by[policy] = comps
    for a, b in zip(by["async"], by["lockstep"]):
        assert a.seq == b.seq and a.traj.actions == b.traj.actions
        assert a.result.latency == b.result.latency


def test_edf_and_monitor_without_tracer_serve(port_world):
    """`policy="edf"` serves through the ported QoS plane's EdfPolicy: of
    three queries arriving together on one lane, the earliest deadline
    is admitted first. `monitor=` without `obs=` serves with a `Tracer`
    the service creates, whose span trees the monitor reads."""
    db, wl, agent = port_world
    sched = LaneScheduler(db, Estimator(db, db.stats), agent, n_lanes=1,
                          policy="edf")
    comps = sched.run([Arrival(0.0, query=wl.test[i], seed=i, deadline=dl)
                       for i, dl in enumerate((30.0, 10.0, 20.0))])
    assert [c.seq for c in sorted(comps, key=lambda c: c.admit_t)] == \
        [1, 2, 0]
    mon = SloMonitor()
    svc = QueryService(db, agent, n_lanes=2, monitor=mon)
    assert isinstance(svc.obs, Tracer)
    comps, stats = svc.run([Arrival(0.0, query=wl.test[i], seed=i)
                            for i in range(3)])
    assert stats.n_completed == 3 and len(comps) == 3
    assert svc.scheduler.obs is svc.obs
    assert len(svc.obs.roots()) == 3
    assert mon.summary()["n_records"] == 3


@pytest.mark.parametrize("keyed", [False, True])
def test_serial_rollout_matches_reference(port_world, reference_world, keyed):
    """One query at a time through `core.rollout.rollout`: greedy `act`
    (single state) without a key, `act_keyed` (a batch of one) with one."""
    db, wl, agent = port_world
    jdb, jwl, jagent = reference_world
    est, jest = Estimator(db, db.stats), JEstimator(jdb, jdb.stats)
    for i in range(3):
        key = 100 + i if keyed else None
        t = rollout(db, wl.test[i], est, agent, explore=False, key=key)
        r = j_rollout(jdb, jwl.test[i], jest, jagent, explore=False, key=key)
        assert t.actions == r.actions and t.rewards == r.rewards
        assert t.t_execute == r.t_execute and t.failed == r.failed
        np.testing.assert_allclose(t.logps, r.logps, atol=1e-4)
