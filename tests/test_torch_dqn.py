"""The port's DQN agent against the reference's, on the CPU.

Its seeded Q-network, its epsilon-greedy `act`, `record`, `train_step`
and target syncs, each held to `repro.core.dqn.DQNAgent` on the same
states: free-running through `train_agent` up to the first train step,
and in lockstep (the reference's state installed on the port before
each episode) across train steps and target syncs. Tolerances are stated
at each check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.dqn import DQNAgent as JDQN  # noqa: E402
from repro.core.dqn import DQNConfig as JDQNConfig  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro.core.rollout import rollout as jrollout  # noqa: E402
from repro.core.train_loop import train_agent as jtrain_agent  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.agent import AgentConfig, param_tree  # noqa: E402
from repro_torch.core.dqn import DQNAgent, DQNConfig  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.core.rollout import rollout  # noqa: E402
from repro_torch.core.train_loop import train_agent  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402


def _flat(tree_):
    return dict(tree.flatten(tree.tree_map(
        lambda x: x.detach().numpy().copy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree_)))


def _agents(job_workload, seed=0, **dqn_kw):
    ref = JDQN(JMeta.from_workload(job_workload), JAgentConfig(),
               dqn=JDQNConfig(**dqn_kw), seed=seed)
    port = DQNAgent(WorkloadMeta.from_workload(job_workload), AgentConfig(),
                    dqn=DQNConfig(**dqn_kw), seed=seed, device="cpu")
    return ref, port


def _record_train_steps(agent, out):
    """Append each train step's loss to `out` (the agent's `ppo_update`
    calls `self.train_step`)."""
    inner = agent.train_step

    def train_step():
        out.append(inner())
        return out[-1]
    agent.train_step = train_step


@pytest.mark.parametrize("seed", [0, 1])
def test_dqn_initialisation_matches_reference(job_workload, seed,
                                              monkeypatch):
    """Q-network leaves bit-equal to the reference's (split(PRNGKey(s),
    2)); the target equal to it but a copy; the same parameter count and
    first draws of the exploration rng; no device asks for CUDA."""
    ref, port = _agents(job_workload, seed=seed)
    want = _flat(jax.tree_util.tree_map(np.asarray, ref.qnet))
    got = _flat(param_tree(port.qnet))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    for a, b in zip(port.qnet.parameters(), port.target.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert port.param_count() == ref.param_count()
    assert port.rng.random() == ref.rng.random()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DQNAgent(port.meta)


def test_dqn_train_agent_matches_reference_to_first_train_step(
        job_db, job_workload, estimator):
    """`train_agent(agent=dqn, episodes=32)`, serial, from seed 0 on each
    side: every episode before the first train step identical (query,
    actions, latency, failure), and the first `train_step`'s loss (B=64
    sampled transitions at N=64) within 1e-5 relative."""
    ref, port = _agents(job_workload)
    ref_losses, port_losses = [], []
    _record_train_steps(ref, ref_losses)
    _record_train_steps(port, port_losses)
    _, want = jtrain_agent(job_db, job_workload, episodes=32, seed=0,
                           est=estimator, agent=ref)
    _, got = train_agent(job_db, job_workload, episodes=32, seed=0,
                         est=Estimator(job_db, job_db.stats), agent=port)
    first = next(i for i, l in enumerate(ref_losses) if l != 0.0)
    assert first == next(i for i, l in enumerate(port_losses) if l != 0.0)
    episode = first // 4                      # 4 train steps an episode
    assert 0 < episode < 32 and len(ref.buffer) >= 64
    for w, g in zip(want[:episode + 1], got[:episode + 1]):
        assert (g.query, g.actions, g.latency, g.failed) == \
            (w.query, w.actions, w.latency, w.failed)
    np.testing.assert_allclose(port_losses[first], ref_losses[first],
                               rtol=1e-5)


def _install(port, ref):
    """The reference's Q-network, target and AdamW state onto the port."""
    def put(p, x):
        p.copy_(torch.from_numpy(np.array(x)))
    with torch.no_grad():
        tree.tree_map(put, param_tree(port.qnet), ref.qnet)
        tree.tree_map(put, param_tree(port.target), ref.target)
    port.opt = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                             ref.opt)


def test_dqn_lockstep_train_steps_and_target_syncs(job_db, job_workload,
                                                   estimator):
    """Ten exploring episodes (batch 8, target sync every 3 episodes),
    the reference's state installed on the port before each: the same
    actions, the same transitions recorded (states, actions, rewards,
    next masks, done flags exactly), each train step's loss within 1e-5
    relative, the Q-network, AdamW and target leaves within 1e-5 (abs +
    rel) after each episode. Every train step on the port leaves the
    target untouched; a sync copies the Q-network (equal values, its own
    tensors). Then greedy `act` and `value` on the last states: the same
    actions, values within 1e-4."""
    kw = dict(batch_size=8, target_sync=3, hidden=32, head_hidden=32)
    ref, port = _agents(job_workload, seed=3, **kw)
    est = Estimator(job_db, job_db.stats)
    untouched = []
    inner = port.train_step

    def train_step():
        before = _flat(param_tree(port.target))
        loss = inner()
        after = _flat(param_tree(port.target))
        untouched.append(all(np.array_equal(after[k], v)
                             for k, v in before.items()))
        return loss
    port.train_step = train_step
    ref_losses, port_losses = [], []
    _record_train_steps(ref, ref_losses)
    _record_train_steps(port, port_losses)
    for ep in range(10):
        _install(port, ref)
        q = job_workload.train[ep]
        want = jrollout(job_db, q, estimator, ref, stage=3, explore=True)
        got = rollout(job_db, q, est, port, stage=3, explore=True)
        assert got.actions == want.actions and \
            got.t_execute == want.t_execute
        ref.ppo_update(want)
        port.ppo_update(got)
        assert len(port.buffer) == len(ref.buffer)
        for a, b in zip(port.buffer, ref.buffer):
            for x, y in zip(a[0] + a[3], b[0] + b[3]):
                np.testing.assert_array_equal(x, y)
            assert (a[1], a[2], a[5]) == (b[1], b[2], b[5])
            np.testing.assert_array_equal(a[4], b[4])
        np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5)
        want_leaves = _flat(jax.tree_util.tree_map(np.asarray, {
            "q": ref.qnet, "t": ref.target, "o": ref.opt}))
        got_leaves = _flat({"q": param_tree(port.qnet),
                            "t": param_tree(port.target), "o": port.opt})
        for name, w in want_leaves.items():
            np.testing.assert_allclose(got_leaves[name], w, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert port.episode == ref.episode == 10
    assert sum(l != 0.0 for l in port_losses) >= 8 and all(untouched)
    for a, b in zip(port.qnet.parameters(), port.target.parameters()):
        assert a.data_ptr() != b.data_ptr()

    for s, am in zip(got.states, got.masks):
        assert port.act(s, am, explore=False)[0] == \
            ref.act(s, am, explore=False)[0]
        assert port.value(s) == pytest.approx(ref.value(s), rel=1e-4,
                                              abs=1e-4)
