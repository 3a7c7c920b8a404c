"""The port's training path against the reference's, on the CPU.

AdamW, the fused encoder's backward, the PPO update, seeded exploring
rollouts, the training loop and the agent-state checkpoints, each fed
the same numpy inputs (or the same trajectories, parameters and AdamW
states) as the JAX package. Tolerances are stated at each check.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import agent_state as jagent_state  # noqa: E402
from repro.checkpoint import install_agent_state as jinstall  # noqa: E402
from repro.core import nets as jnets  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro.core.train_loop import train_agent as jtrain_agent  # noqa: E402
from repro.core.vec_rollout import rollout_batch as jrollout_batch  # noqa: E402
from repro.kernels.tree_conv import tree_cnn_fused as jfused  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, agent_state,  # noqa: E402
                                    agent_state_from_numpy,
                                    agent_state_to_numpy,
                                    install_agent_state,
                                    load_reference_checkpoint, params_finite)
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.core.rollout import rollout  # noqa: E402
from repro_torch.core.train_loop import train_agent  # noqa: E402
from repro_torch.core.vec_rollout import rollout_batch  # noqa: E402
from repro_torch.kernels import ref, tree_conv  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402

STEP = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "aqora_ckpt" / "step_00000018"


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _flat(tree_):
    return dict(tree.flatten(tree.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree_)))


# ----------------------------------------------------------------- (a) AdamW
@pytest.mark.parametrize("steps,grad_scale,wd", [(1, 1.0, 0.1), (5, 1.0, 0.1),
                                                 (5, 40.0, 0.0)])
def test_adamw_matches_reference(steps, grad_scale, wd):
    """One and five steps from identical params and grads; grad_scale 40
    puts the global norm above the clip (a clipped step). 1e-6 relative,
    to each leaf's largest magnitude: XLA may fuse m's b1*m + (1-b1)*g
    into one FMA, so a moment that cancels to ~1e-9 differs in its last
    bits."""
    rng = np.random.default_rng(steps)
    shapes = {"enc": {"w": (26, 96), "b": (96,)}, "head": {"w2": (96, 7)}}
    params = {k: {n: rng.standard_normal(s).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
    grads = [{k: {n: (grad_scale * rng.standard_normal(s)).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
             for _ in range(steps)]
    jcfg = JAdamWConfig(lr=1e-3, weight_decay=wd)
    cfg = AdamWConfig(lr=1e-3, weight_decay=wd)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadamw_init(jp)
    tp = tree.tree_map(lambda x: torch.from_numpy(x.copy()), params)
    ts = adamw_init(tp)
    for g in grads:
        jp, js, jm = jadamw_update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                   js, jcfg)
        tp, ts, tm = adamw_update(tp, tree.tree_map(torch.from_numpy, g), ts,
                                  cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == steps
    assert ts["step"].dtype == torch.int32
    want = _flat({"p": _np(jp), "m": _np(js["m"]), "v": _np(js["v"])})
    got = _flat({"p": tp, "m": ts["m"], "v": ts["v"]})
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


# --------------------------------------------------------- (c) the backward
def _trees(B, N, F, seed, tie=False):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, N, F)).astype(np.float32)
    left = rng.integers(0, N, (B, N)).astype(np.int32)
    right = rng.integers(0, N, (B, N)).astype(np.int32)
    mask = (rng.random((B, N)) > 0.3).astype(np.float32)
    mask[:, 0] = 0.0
    mask[-1] = 0.0                                  # an all-masked tree
    if tie:              # node 2 repeats node 1 exactly: every channel ties
        feat[:, 2] = feat[:, 1]
        left[:, 2], right[:, 2] = left[:, 1], right[:, 1]
        mask[:-1, 1:3] = 1.0
        feat[:, 3:] *= 0.01                         # so the pair holds the max
    return feat, left, right, mask


@pytest.mark.parametrize("B,N,F,H,tie", [(4, 32, 10, 24, False),
                                         (5, 48, 26, 96, False),
                                         (3, 16, 9, 40, True)])
def test_fused_backward_matches_jax_grad(B, N, F, H, tie):
    """Grads of sum(out**2) through the port's `tree_cnn_fused` (CPU:
    the Function's plain backward) against jax.grad through the
    reference's fused kernel in interpret mode (its custom VJP), for all
    weights, feat and mask, in-range child indices. 1e-4 (abs + rel).
    With `tie`, two identical nodes hold channel maxima together, where
    jax splits the pool's cotangent evenly."""
    feat, left, right, mask = _trees(B, N, F, seed=B * N + F, tie=tie)
    params = jnets._init_treecnn(jax.random.PRNGKey(H), F, H)
    brng = np.random.default_rng(H)
    for lname in params:                      # nonzero biases
        params[lname]["b"] = jnp.asarray(
            0.1 * brng.standard_normal(H).astype(np.float32))

    def loss(p, f, m):
        out = jfused(f, jnp.asarray(left), jnp.asarray(right), m, p,
                     interpret=True)
        return jnp.sum(out ** 2)

    gp, gf, gm = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(feat), jnp.asarray(mask))
    tp = tree.tree_map(lambda x: torch.tensor(np.asarray(x),
                                              requires_grad=True), params)
    tf = torch.tensor(feat, requires_grad=True)
    tm = torch.tensor(mask, requires_grad=True)
    out = tree_conv.tree_cnn_fused(tf, torch.from_numpy(left),
                                   torch.from_numpy(right), tm, tp)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(gm), atol=1e-4,
                               rtol=1e-4)
    for name, g in _flat(_np(gp)).items():
        got = _flat(tree.tree_map(lambda t: t.grad, tp))[name]
        np.testing.assert_allclose(got, g, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert not tf.grad[-1].any() and not tm.grad[-1].any()


def test_plain_backward_against_finite_differences():
    """fp64 finite differences of the plain forward against
    `ref.tree_cnn_fused_bwd_ref`, out-of-range children and non-binary
    mask values included. The mask enters through m = s * base, so no
    step moves a masked-out node (m = 0) into the pool."""
    rng = np.random.default_rng(3)
    B, N, F, H = 2, 8, 3, 4
    feat = torch.from_numpy(rng.standard_normal((B, N, F)))
    left = torch.from_numpy(rng.integers(-2, N + 2, (B, N)).astype(np.int32))
    right = torch.from_numpy(rng.integers(-2, N + 2, (B, N)).astype(np.int32))
    base = torch.from_numpy((rng.random((B, N)) > 0.3).astype(np.float64))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (B, N)))
    params = {l: {w: torch.from_numpy(rng.standard_normal(
        (H,) if w == "b" else (F if i == 0 else H, H)))
        for w in tree_conv.WEIGHTS} for i, l in enumerate(tree_conv.LAYERS)}
    weights = [params[l][w] for l in tree_conv.LAYERS
               for w in tree_conv.WEIGHTS]

    def fn(f, s, *ws):
        it = iter(ws)
        p = {l: {w: next(it) for w in tree_conv.WEIGHTS}
             for l in tree_conv.LAYERS}
        return ref.tree_cnn_fused_ref(f, left, right, s * base, p)

    inputs = [t.clone().requires_grad_(True) for t in (feat, scale, *weights)]
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)
    g = torch.from_numpy(rng.standard_normal((B, H)))
    gf, gm, gp = ref.tree_cnn_fused_bwd_ref(feat, left, right, scale * base,
                                            params, g)
    want = torch.autograd.grad(fn(*inputs), inputs, g)
    torch.testing.assert_close(gf, want[0])
    live = base > 0
    torch.testing.assert_close(gm[live], want[1][live])
    got_w = [gp[l][w] for l in tree_conv.LAYERS for w in tree_conv.WEIGHTS]
    for a, b in zip(got_w, want[2:]):
        torch.testing.assert_close(a, b)


# ----------------------------------------------- agents from identical state
@pytest.fixture(scope="module")
def pair(job_workload):
    """The reference agent and the port's (CPU) from step 18's full state:
    params and both AdamW states."""
    meta = JMeta.from_workload(job_workload)
    ref_agent = JAgent(meta, JAgentConfig(), seed=0)
    state, _, _ = JCheckpointer(STEP.parent).restore(jagent_state(ref_agent),
                                                     step=18)
    jinstall(ref_agent, state)
    port = AqoraAgent(WorkloadMeta.from_workload(job_workload), AgentConfig(),
                      seed=0, device="cpu")
    install_agent_state(port, agent_state_from_numpy(
        load_reference_checkpoint(STEP)))
    return ref_agent, port


def test_ppo_update_batch_matches_reference(job_db, job_workload, estimator,
                                            pair):
    """The reference's trajectories (8 lanes: up to 24 actor and 32 critic
    states) through one `ppo_update_batch` of 6 epochs on each side from
    identical state: losses to 1e-5 relative, every param and AdamW leaf
    to 1e-5 absolute."""
    ref_src, port_src = pair
    ref_agent = ref_src.clone(seed=0)
    port = port_src.clone(seed=0)
    trajs = jrollout_batch(job_db, job_workload.train[:8], estimator,
                           ref_agent, stage=3, explore=True,
                           seeds=list(range(30, 38)))
    assert sum(len(t.actions) for t in trajs) > 8
    m_ref = ref_agent.ppo_update_batch(trajs)
    m_port = port.ppo_update_batch(trajs)
    for k in ("actor_loss", "critic_loss"):
        np.testing.assert_allclose(m_port[k], m_ref[k], rtol=1e-5, err_msg=k)
    want = _flat(_np(jagent_state(ref_agent)))
    got = _flat(agent_state(port))
    assert set(got) == set(want)
    start = int(load_reference_checkpoint(STEP)["aopt"]["step"])
    assert int(got["aopt/step"]) == int(want["aopt/step"]) == start + 6
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=0,
                                   err_msg=name)


# ------------------------------------------------- (e) exploring rollouts
def test_exploring_rollouts_match_reference(job_db, job_workload, estimator,
                                            pair):
    """Seeded lockstep rollouts with explore=True take the reference's
    actions (logps to 1e-5); a serial `rollout(key=s)` equals lane s."""
    ref_agent, port = pair
    est = Estimator(job_db, job_db.stats)
    qs, seeds = job_workload.train[8:14], [3, 17, 29, 101, 2 ** 31 - 5, 7]
    want = jrollout_batch(job_db, qs, estimator, ref_agent, stage=3,
                          explore=True, seeds=seeds)
    got = rollout_batch(job_db, qs, est, port, stage=3, explore=True,
                        seeds=seeds)
    for w, g in zip(want, got):
        assert g.actions == w.actions
        assert g.t_execute == w.t_execute and g.failed == w.failed
        np.testing.assert_allclose(g.logps, w.logps, atol=1e-5)
    for q, s, lane in zip(qs[:2], seeds[:2], got[:2]):
        serial = rollout(job_db, q, est, port, stage=3, explore=True, key=s)
        assert serial.actions == lane.actions
        assert serial.t_execute == lane.t_execute
        np.testing.assert_allclose(serial.logps, lane.logps, atol=1e-6)


def test_serial_act_samples_as_reference(pair):
    """`act(explore=True)` draws from the agent's own key chain with
    `jax.random.choice`'s rule: same actions as the reference's."""
    ref_agent, port = pair
    rng = np.random.default_rng(4)
    a_ref, a_port = ref_agent.clone(seed=11), port.clone(seed=11)
    N, F = 64, port.meta.feat_dim
    for i in range(6):
        n = int(rng.integers(4, 30))
        feat = np.zeros((N, F), np.float32)
        feat[1:n] = rng.standard_normal((n - 1, F))
        left = np.zeros(N, np.int32)
        right = np.zeros(N, np.int32)
        left[1:n] = rng.integers(0, n, n - 1)
        right[1:n] = rng.integers(0, n, n - 1)
        mask = np.zeros(N, np.float32)
        mask[1:n] = 1.0
        amask = (rng.random(port.space.d) > 0.3).astype(np.float32)
        enc = (feat, left, right, mask)
        r = a_ref.act(enc, amask, explore=True)
        p = a_port.act(enc, amask, explore=True)
        assert p[0] == r[0] and abs(p[1] - r[1]) < 1e-4
    np.testing.assert_array_equal(a_port.rng, np.asarray(a_ref.rng))


# ------------------------------------------------------ (f) training loop
def test_train_agent_batched_matches_reference(job_db, job_workload,
                                               estimator, pair):
    """`train_agent(episodes=8, batch_size=4)` from identical state: finite
    logs, and the first episode-batch equals the reference's."""
    ref_src, port_src = pair
    _, want = jtrain_agent(job_db, job_workload, episodes=8, seed=0,
                           est=estimator, batch_size=4,
                           agent=ref_src.clone(seed=0))
    agent, got = train_agent(job_db, job_workload, episodes=8, seed=0,
                             est=Estimator(job_db, job_db.stats),
                             batch_size=4, agent=port_src.clone(seed=0),
                             device="cpu")
    assert [l.episode for l in got] == list(range(8))
    assert all(np.isfinite(l.actor_loss) and np.isfinite(l.critic_loss)
               for l in got)
    for w, g in zip(want[:4], got[:4]):
        assert (g.query, g.actions, g.latency, g.failed) == \
            (w.query, w.actions, w.latency, w.failed)
        np.testing.assert_allclose(g.actor_loss, w.actor_loss, rtol=1e-5)
        np.testing.assert_allclose(g.critic_loss, w.critic_loss, rtol=1e-5)
    assert params_finite(agent)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_agent_from_a_seed_matches_reference(job_db, job_workload,
                                                   estimator, seed):
    """Alg. 1 from scratch: `train_agent(episodes=8, batch_size=4,
    seed=s)` with no `agent=` builds the reference's initial agent, so its
    first episode-batch takes the reference's actions, with losses to
    1e-5 relative."""
    _, want = jtrain_agent(job_db, job_workload, episodes=8, seed=seed,
                           est=estimator, batch_size=4)
    _, got = train_agent(job_db, job_workload, episodes=8, seed=seed,
                         est=Estimator(job_db, job_db.stats), batch_size=4,
                         device="cpu")
    for w, g in zip(want[:4], got[:4]):
        assert (g.query, g.actions, g.latency, g.failed) == \
            (w.query, w.actions, w.latency, w.failed)
        np.testing.assert_allclose(g.actor_loss, w.actor_loss, rtol=1e-5)
        np.testing.assert_allclose(g.critic_loss, w.critic_loss, rtol=1e-5)


def test_train_agent_builds_its_agent_on_the_device(job_db, job_workload):
    agent, logs = train_agent(job_db, job_workload, episodes=2, seed=1,
                              batch_size=1, device="cpu",
                              cfg=AgentConfig(hidden=16, head_hidden=16,
                                              ppo_epochs=2))
    assert agent.device.type == "cpu" and len(logs) == 2
    assert all(np.isfinite(l.actor_loss) for l in logs)
    assert int(agent.aopt["step"]) == 4


# ------------------------------------------------------ (g) checkpoints
def test_checkpoints_cross_both_ways(tmp_path, pair):
    """A checkpoint the port writes restores in the reference's
    `Checkpointer`, and one the reference writes restores in the port's:
    every leaf bit-equal, dtypes and shapes kept."""
    ref_agent, port = pair
    trained = port.clone(seed=0)
    with torch.no_grad():
        for p in trained.actor.parameters():
            p.add_(0.125)
    trained.aopt["step"] = trained.aopt["step"] + 3
    Checkpointer(tmp_path / "port").save(5, agent_state(trained),
                                         extra={"episodes": 5})
    got, step, extra = JCheckpointer(tmp_path / "port").restore(
        jagent_state(ref_agent))
    assert step == 5 and extra == {"episodes": 5}
    want = _flat(agent_state(trained))
    for name, arr in _flat(_np(got)).items():
        assert arr.dtype == want[name].dtype, name
        np.testing.assert_array_equal(arr, want[name], err_msg=name)

    JCheckpointer(tmp_path / "ref").save(7, jagent_state(ref_agent))
    tree_, step, _ = Checkpointer(tmp_path / "ref").restore(
        agent_state(trained))
    assert step == 7
    back = AqoraAgent(port.meta, port.cfg, seed=0, device="cpu")
    install_agent_state(back, tree_)
    want = _flat(_np(jagent_state(ref_agent)))
    got = _flat(agent_state(back))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert agent_state_to_numpy(agent_state(back))["aopt"]["step"].dtype \
        == np.int32


def test_install_copies_and_clone_is_independent(pair):
    _, port = pair
    twin = port.clone(seed=4)
    assert params_finite(twin)
    with torch.no_grad():
        next(twin.actor.parameters()).add_(1.0)
    twin.aopt["m"]["head"]["w2"].add_(1.0)
    a = _flat(agent_state(port))
    b = _flat(agent_state(twin))
    assert not np.array_equal(a["actor/enc/conv1/wr"], b["actor/enc/conv1/wr"])
    assert not np.array_equal(a["aopt/m/head/w2"], b["aopt/m/head/w2"])
    np.testing.assert_array_equal(a["critic/head/w1"], b["critic/head/w1"])
