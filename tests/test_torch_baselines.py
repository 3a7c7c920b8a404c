"""The port's Lero and AutoSteer baselines and its experiment runner
against the reference's, on the CPU.

Lero and AutoSteer from one seed: weights bit-equal, then trained in
lockstep (the reference's scorer and AdamW state installed on the port
before each episode) on the same queries: the same training pairs and
toggle sets, leaves within 1e-5, then the same chosen plans and toggles
on the test queries. Then `main_experiment.run_bench` on a small
database with both packages: Spark default, Lero and AutoSteer rows
identical apart from their wall-clock fields (`plan_time`, `total`:
`cbo_plan` charges its own wall time), and AQORA's first episode-batch
identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.baselines import AutoSteerOptimizer as JAutoSteer  # noqa: E402
from repro.baselines import LeroOptimizer as JLero  # noqa: E402
from repro.baselines.lero import _order_sig as j_order_sig  # noqa: E402
from repro.experiments import main_experiment as jmain  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.baselines import (AutoSteerOptimizer,  # noqa: E402
                                   LeroOptimizer)
from repro_torch.baselines.lero import _order_sig  # noqa: E402
from repro_torch.core.agent import param_tree  # noqa: E402
from repro_torch.experiments import main_experiment as pmain  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402

WALL_CLOCK = ("plan_time", "total")


def _flat(tree_):
    return dict(tree.flatten(tree.tree_map(
        lambda x: x.detach().numpy().copy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree_)))


def _install(port, ref):
    """The reference's scorer and AdamW state onto the port's."""
    with torch.no_grad():
        tree.tree_map(lambda p, x: p.copy_(torch.from_numpy(np.array(x))),
                      param_tree(port.net), ref.net)
    port.opt = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                             ref.opt)


def _assert_leaves(port, ref, exact=False):
    want = _flat({"net": jax.tree_util.tree_map(np.asarray, ref.net),
                  "opt": jax.tree_util.tree_map(np.asarray, ref.opt)})
    got = _flat({"net": param_tree(port.net), "opt": port.opt})
    assert set(got) == set(want)
    for name, w in want.items():
        if exact:
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def _run_row(r):
    return (r.latency, r.failed, r.total_shuffles, r.bushy)


def test_lero_lockstep_matches_reference(job_db, job_workload, estimator):
    """Six training episodes in lockstep: the same candidate features and
    latencies, the same pairs, the scorer's leaves and AdamW state
    within 1e-5 (abs + rel) after each episode's 4 steps; then on 6 test
    queries the same candidates and chosen plan, and `run`'s latency,
    failure, shuffles and bushiness (not `plan_time`: wall clock)."""
    ref = JLero(job_db, estimator, seed=0)
    port = LeroOptimizer(job_db, Estimator(job_db, job_db.stats), seed=0,
                         device="cpu")
    _assert_leaves(port, ref, exact=True)
    for q in job_workload.train[:6]:
        _install(port, ref)
        want = ref.train_episode(q)
        got = port.train_episode(q)
        assert [l for _, l in got] == [l for _, l in want]
        for (f, _), (g, _) in zip(got, want):
            np.testing.assert_array_equal(f, g)
        _assert_leaves(port, ref)
    assert len(port._pairs) == len(ref._pairs) >= 8
    assert int(port.opt["step"]) == int(ref.opt["step"]) > 0
    _install(port, ref)
    for q in job_workload.test[:6]:
        plan, _, cands = port.choose(q)
        jplan, _, jcands = ref.choose(q)
        assert [_order_sig(p) for p in cands] == \
            [j_order_sig(p) for p in jcands]
        assert _order_sig(plan) == j_order_sig(jplan)
        assert _run_row(port.run(q)) == _run_row(ref.run(q))


def test_autosteer_lockstep_matches_reference(job_db, job_workload,
                                              estimator):
    """Six training episodes in lockstep from `default_rng(0)` on each
    side: the same explored toggle sets and observed sqrt-latencies, the
    predictor's leaves and AdamW state within 1e-5 (abs + rel) after each
    episode; then on 6 test queries the same greedy toggle set and
    EXPLAIN count, and `run`'s latency, failure, shuffles and bushiness."""
    ref = JAutoSteer(job_db, estimator, seed=0)
    port = AutoSteerOptimizer(job_db, Estimator(job_db, job_db.stats),
                              seed=0, device="cpu")
    _assert_leaves(port, ref, exact=True)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for q in job_workload.train[:6]:
        _install(port, ref)
        ref.train_episode(q, jrng)
        port.train_episode(q, rng)
        np.testing.assert_array_equal(np.stack(port._xs), np.stack(ref._xs))
        assert port._ys == ref._ys
        _assert_leaves(port, ref)
    assert int(port.opt["step"]) == int(ref.opt["step"]) > 0
    _install(port, ref)
    for q in job_workload.test[:6]:
        assert port.choose(q) == ref.choose(q)
        assert _run_row(port.run(q)) == _run_row(ref.run(q))


def test_run_bench_matches_reference(job_db, tmp_path, monkeypatch):
    """`run_bench("job")` on conftest's small database (24 training
    queries, 1 test query a template, 4 baseline episodes, one AQORA
    episode-batch of 4) with each package, results under tmp_path:
    the Spark rows identical; the Lero and AutoSteer rows identical but
    for `plan_time` and `total` (wall clock); AQORA's episode-batch of
    training logs identical; the parameter count equal. The port's
    results go to its own file."""
    for mod, name in ((jmain, "ref"), (pmain, "port")):
        monkeypatch.setattr(mod, "RESULTS", tmp_path / name)
        monkeypatch.setattr(mod, "BASELINE_EPISODES", 4)
        monkeypatch.setattr(mod, "N_TRAIN", {"job": 24})
        monkeypatch.setattr(mod, "N_TEST_PER_TEMPLATE", {"job": 1})
    kw = dict(episodes=4, batch_size=4, quiet=True, train_db=job_db)
    want = jmain.run_bench("job", **kw)
    got = pmain.run_bench("job", device="cpu", **kw)
    assert (tmp_path / "port" / "job.json").exists()
    assert got["spark"] == want["spark"]
    for system in ("lero", "autosteer"):
        assert len(got[system]) == len(want[system]) > 0
        for g, w in zip(got[system], want[system]):
            assert {k: v for k, v in g.items() if k not in WALL_CLOCK} == \
                {k: v for k, v in w.items() if k not in WALL_CLOCK}
    assert got["aqora_training"] == want["aqora_training"]
    assert got["agent_params"] == want["agent_params"]
    assert len(got["aqora"]) == len(want["aqora"])


@pytest.mark.parametrize("cls", [LeroOptimizer, AutoSteerOptimizer])
def test_baselines_without_device_need_cuda(cls, job_db, monkeypatch):
    est = Estimator(job_db, job_db.stats)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(job_db, est)
    assert cls(job_db, est, device="cpu").device.type == "cpu"
