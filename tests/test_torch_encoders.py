"""The port's LSTM, FCNN and QueryFormer encoders against the reference's,
on the CPU.

Each encoder's forward (single state and batch, with an all-masked tree)
and its gradient against `nets.apply_encoder` and `jax.grad` (1e-4, abs
+ rel); seeded weights bit-equal; the agent's `act_batch` and one
`ppo_update_batch` of each encoder from the reference's state on the
reference's trajectories (losses to 1e-5 relative, leaves to 1e-5
abs + rel); the latency predictor of each encoder; a
QueryFormer checkpoint (whose reference tree holds a list) crossing both
ways. Inputs are made from numpy seeds and given to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import agent_state as jagent_state  # noqa: E402
from repro.core import nets as jnets  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro.core.vec_rollout import rollout_batch as jrollout_batch  # noqa: E402
from repro.serve.qos import LatencyPredictor as JPredictor  # noqa: E402
from repro.serve.qos import encode_query as j_encode_query  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, agent_state,  # noqa: E402
                                    agent_state_from_numpy,
                                    install_agent_state, params_from_numpy)
from repro_torch.core import nets, prng  # noqa: E402
from repro_torch.core.agent import AgentConfig, AqoraAgent, param_tree  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.serve.qos import LatencyPredictor  # noqa: E402

KINDS = ("lstm", "fcnn", "queryformer")
TABLES = {f"t{i}": i for i in range(13)}        # feat_dim 19, as ExtJOB's


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _flat(tree_):
    return dict(tree.flatten(tree.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree_)))


def _states(B, N, F, seed):
    """Random trees on slots 1..n (slot 0 = the null child); the last
    tree is all-masked."""
    rng = np.random.default_rng(seed)
    feat = np.zeros((B, N, F), np.float32)
    left = np.zeros((B, N), np.int32)
    right = np.zeros((B, N), np.int32)
    mask = np.zeros((B, N), np.float32)
    for b in range(B - 1):
        n = int(rng.integers(2, N + 1))
        feat[b, 1:n] = rng.standard_normal((n - 1, F))
        mask[b, 1:n] = 1.0
        left[b, 1:n] = rng.integers(0, n, n - 1)
        right[b, 1:n] = rng.integers(0, n, n - 1)
    return feat, left, right, mask


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)


# ------------------------------------------------------- forward, gradient
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_encoder_and_gradient_match_reference(kind, N):
    """`make_encoder(kind)` from the reference's key: its weights are the
    reference's bit for bit; batched (5 trees, the last all-masked) and
    single-state outputs within 1e-4 of `apply_encoder`; the gradients
    of sum(out**2) in every weight and in feat within 1e-4 of
    `jax.grad`'s. The FCNN flattens `max_nodes` = N slots."""
    F, H = 19, 32
    params = jnets.init_encoder(jax.random.PRNGKey(N), kind, F, H, N)
    enc = nets.make_encoder(kind, F, H, prng.prng_key(N), N)
    want_w = _flat(_np(params))
    got_w = _flat(param_tree(enc))
    assert set(got_w) == set(want_w)
    for name, w in want_w.items():
        np.testing.assert_array_equal(got_w[name], w, err_msg=name)

    batch = _states(5, N, F, seed=N)
    feat, left, right, mask = map(jnp.asarray, batch)

    def loss(p, f):
        return jnp.sum(jnets.apply_encoder(p, kind, f, left, right, mask) ** 2)

    want = jax.jit(jnets.apply_encoder, static_argnums=1)(
        params, kind, feat, left, right, mask)
    gp, gf = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, feat)
    t = [torch.from_numpy(x) for x in batch]
    tf = t[0].clone().requires_grad_(True)
    out = enc(tf, *t[1:])
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), np.asarray(want), 1e-4)
    assert not out[-1].detach().any()           # the all-masked tree
    with torch.no_grad():
        single = enc(*(x[2] for x in t))
    _close(single.numpy(), np.asarray(jnets.apply_encoder(
        params, kind, *(x[2] for x in (feat, left, right, mask)))), 1e-4)
    _close(tf.grad.numpy(), np.asarray(gf), 1e-4, "feat")
    got_g = _flat({k: v.grad for k, v in enc.named_parameters()})
    for name, g in _flat(_np(gp)).items():
        _close(got_g[name.replace("/", ".")], g, 1e-4, name)


def test_pool_splits_tied_gradients_as_jnp_max():
    """The masked max-pool's gradient with tied maxima: split evenly among
    the ties, as `jnp.max`'s (torch.max(dim=) would give all of it to
    one index). Exact."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 6, 4)).astype(np.float32)
    h[0, 2] = h[0, 4] = 9.0                     # a two-way tie
    h[1, :3] = 7.0                              # a three-way tie
    mask = np.ones((3, 6), np.float32)
    mask[1, 1] = 0.0                            # one tie masked out
    mask[2] = 0.0                               # all masked: pools to 0
    w = rng.standard_normal((3, 4)).astype(np.float32)

    def jpool(x):
        neg = jnp.where(mask[..., None] > 0, x, -jnp.inf)
        pooled = jnp.max(neg, axis=1)
        return jnp.sum(jnp.where(jnp.isfinite(pooled), pooled, 0.0) * w)

    th = torch.tensor(h, requires_grad=True)
    (nets._masked_max_pool(th, torch.from_numpy(mask))
     * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax.grad(jpool)(jnp.asarray(h)))
    np.testing.assert_array_equal(th.grad.numpy(), want)
    assert th.grad[0, 2, 0] == th.grad[0, 4, 0] == w[0, 0] / 2


# ------------------------------------------------------- seeded weights
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_fresh_agent_matches_reference_initialisation(kind, seed):
    """`AqoraAgent(meta, AgentConfig(net=kind), seed=s)`: every actor and
    critic leaf bit-equal to the reference's, the same leaf names
    (the QueryFormer's "enc/layers/0/wq"), the same parameter count."""
    cfg = dict(net=kind)
    ref = JAgent(JMeta(TABLES, 17), JAgentConfig(**cfg), seed=seed)
    port = AqoraAgent(WorkloadMeta(TABLES, 17), AgentConfig(**cfg),
                      seed=seed, device="cpu")
    for net in ("actor", "critic"):
        want = _flat(_np(getattr(ref, net)))
        got = _flat(param_tree(getattr(port, net)))
        assert set(got) == set(want)
        for name, w in want.items():
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert port.param_count() == ref.param_count()
    assert port._nodes == ref._nodes


# ------------------------------------------------- agents from one state
@pytest.fixture(scope="module", params=KINDS)
def pair(request, job_workload):
    """The reference agent of one encoder (seed 5) and the port's (CPU)
    with the reference's parameters and AdamW states installed."""
    kind = request.param
    ref = JAgent(JMeta.from_workload(job_workload), JAgentConfig(net=kind),
                 seed=5)
    port = AqoraAgent(WorkloadMeta.from_workload(job_workload),
                      AgentConfig(net=kind), seed=0, device="cpu")
    install_agent_state(port, agent_state_from_numpy(_np(jagent_state(ref))))
    return ref, port


def test_act_batch_and_ppo_update_match_reference(pair, job_db,
                                                  job_workload, estimator):
    """`act_batch` greedy and exploring on the reference's rollout states
    (actions and keys equal, logps within 1e-5), then one
    `ppo_update_batch` (6 epochs) on the reference's trajectories of 8
    queries: losses within 1e-5 relative, every parameter and AdamW leaf
    within 1e-5 abs + rel, as the TreeCNN's update is held (a bias that
    moved 1.8e-3 from 0 in 6 AdamW steps differs by 4e-7: AdamW's
    normalised step turns last-bit gradient differences into
    differences of its step). The FCNN's states
    stay untrimmed at 64 slots, the others are trimmed to their bucket."""
    ref, port = pair
    trajs = jrollout_batch(job_db, job_workload.train[:8], estimator, ref,
                           stage=3, explore=True, seeds=list(range(40, 48)))
    states = [s for t in trajs for s in t.states[:2]][:8]
    feat, left, right, mask = (np.stack([s[i] for s in states])
                               for i in range(4))
    amask = np.stack([t.masks[0] for t in trajs])
    keys = np.stack([[0, s] for s in range(7, 15)]).astype(np.uint32)
    for explore in (False, True):
        want = ref.act_batch(feat, left, right, mask, amask, keys,
                             explore=explore)
        got = port.act_batch(feat, left, right, mask, amask, keys,
                             explore=explore)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)
        np.testing.assert_array_equal(got[2], want[2])

    m_ref = ref.ppo_update_batch(trajs)
    m_port = port.ppo_update_batch(trajs)
    for k in ("actor_loss", "critic_loss"):
        np.testing.assert_allclose(m_port[k], m_ref[k], rtol=1e-5, err_msg=k)
    want = _flat(_np(jagent_state(ref)))
    got = _flat(agent_state(port))
    assert set(got) == set(want)
    assert int(got["aopt/step"]) == int(want["aopt/step"]) == 6
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------ predictor
@pytest.mark.parametrize("kind", KINDS)
def test_predictor_matches_reference(kind, job_workload):
    """`LatencyPredictor(net=kind, seed=2)`: weights bit-equal to the
    reference's, predictions on 6 test queries within 1e-5 relative; one
    `fit` step (8 states, batch 8): loss within 1e-5 relative, every leaf
    within 1e-5 of its largest magnitude."""
    jmeta = JMeta.from_workload(job_workload)
    meta = WorkloadMeta.from_workload(job_workload)
    got = LatencyPredictor(meta, net=kind, hidden=32, head_hidden=32, seed=2,
                           device="cpu")
    want = JPredictor(jmeta, net=kind, hidden=32, head_hidden=32, seed=2)
    for name, w in _flat(_np(want.params)).items():
        np.testing.assert_array_equal(_flat(got.params)[name], w,
                                      err_msg=name)
    encs = [j_encode_query(q, jmeta) for q in job_workload.test[:8]]
    for enc in encs[:6]:
        assert got.predict_enc(enc) == pytest.approx(want.predict_enc(enc),
                                                     rel=1e-5)
    lats = [float(x) for x in np.linspace(1.0, 60.0, 8)]
    l_got = got.fit(encs, lats, batch_size=8)
    l_want = want.fit(encs, lats, batch_size=8)
    assert l_got == pytest.approx(l_want, rel=1e-5)
    for name, w in _flat(_np(want.params)).items():
        np.testing.assert_allclose(_flat(got.params)[name], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------- checkpoints
def test_queryformer_checkpoints_cross_both_ways(tmp_path, job_workload):
    """The QueryFormer's layers are a list in the reference's tree
    ("actor/enc/layers/0/wq" in its checkpoints) and an `nn.ModuleList`
    in the port's: a checkpoint the port writes restores in the
    reference's `Checkpointer`, one the reference writes restores in the
    port's, and `params_from_numpy` takes the reference's tree. Every
    leaf bit-equal."""
    cfg = dict(net="queryformer", hidden=32, head_hidden=32)
    ref = JAgent(JMeta.from_workload(job_workload), JAgentConfig(**cfg),
                 seed=1)
    port = AqoraAgent(WorkloadMeta.from_workload(job_workload),
                      AgentConfig(**cfg), seed=3, device="cpu")
    with torch.no_grad():
        port.actor.enc.layers[1].wq.add_(0.25)
    port.aopt["step"] = port.aopt["step"] + 2
    assert "actor/enc/layers/1/wq" in _flat(agent_state(port))

    Checkpointer(tmp_path / "port").save(4, agent_state(port))
    got, step, _ = JCheckpointer(tmp_path / "port").restore(jagent_state(ref))
    assert step == 4 and isinstance(got["actor"]["enc"]["layers"], list)
    want = _flat(agent_state(port))
    restored = _flat(_np(got))
    assert set(restored) == set(want)
    for name, arr in restored.items():
        assert arr.dtype == want[name].dtype, name
        np.testing.assert_array_equal(arr, want[name], err_msg=name)

    JCheckpointer(tmp_path / "ref").save(9, jagent_state(ref))
    tree_, step, _ = Checkpointer(tmp_path / "ref").restore(agent_state(port))
    assert step == 9
    back = AqoraAgent(port.meta, port.cfg, seed=0, device="cpu")
    install_agent_state(back, tree_)
    want = _flat(_np(jagent_state(ref)))
    got = _flat(agent_state(back))
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)

    other = AqoraAgent(port.meta, port.cfg, seed=0, device="cpu")
    other.load_params(params_from_numpy(
        {"actor": _np(ref.actor), "critic": _np(ref.critic)}))
    np.testing.assert_array_equal(
        other.critic.enc.layers[0].wv.detach().numpy(),
        np.asarray(ref.critic["enc"]["layers"][0]["wv"]))
