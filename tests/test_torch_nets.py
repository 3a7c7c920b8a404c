"""The port's networks and agent against the reference's, on the CPU.

Parameters cross over through `checkpoint.params_from_numpy`; inputs are
made from a numpy seed and given to both packages. Tolerance 1e-4, the
reference's own for its fused encoder (tests/test_vec_rollout.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nets as jnets  # noqa: E402
from repro.core.agent import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent import AqoraAgent as JAgent  # noqa: E402
from repro.core.encoding import WorkloadMeta as JMeta  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core import nets  # noqa: E402
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402

TABLES = {f"t{i}": i for i in range(20)}        # feat_dim 26, as JOB's


def _states(B, N, F, seed, n_max=None):
    """Random trees whose used slots are 1..n (slot 0 = null child)."""
    rng = np.random.default_rng(seed)
    feat = np.zeros((B, N, F), np.float32)
    left = np.zeros((B, N), np.int32)
    right = np.zeros((B, N), np.int32)
    mask = np.zeros((B, N), np.float32)
    for b in range(B - 1):                      # last lane stays padding
        n = int(rng.integers(2, n_max or N))
        feat[b, 1:n] = rng.standard_normal((n - 1, F))
        mask[b, 1:n] = 1.0
        left[b, 1:n] = rng.integers(0, n, n - 1)
        right[b, 1:n] = rng.integers(0, n, n - 1)
    return feat, left, right, mask


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("F,H,hh,d", [(26, 96, 96, 172), (9, 24, 16, 7)])
def test_encoder_and_head_match_reference(F, H, hh, d):
    k = jax.random.split(jax.random.PRNGKey(F), 2)
    actor = {"enc": jnets.init_encoder(k[0], "treecnn", F, H),
             "head": jnets.init_mlp_head(k[1], H, hh, d)}
    net = nets.EncoderHead(F, H, hh, d)
    net.load_state_dict(params_from_numpy(
        {"actor": _np_tree(actor), "critic": _np_tree(actor)})["actor"])
    feat, left, right, mask = _states(6, 32, F, seed=H)
    t = [torch.from_numpy(x) for x in (feat, left, right, mask)]
    with torch.no_grad():
        enc = net.enc(*t)
        head = net.head(enc)
        single = net.enc(*(x[2] for x in t))
    ref = jnets.apply_encoder(actor["enc"], "treecnn", *map(jnp.asarray, (
        feat, left, right, mask)))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        head.numpy(), np.asarray(jnets.apply_mlp_head(actor["head"], ref)),
        atol=1e-4, rtol=1e-4)
    ref1 = jnets.apply_encoder(actor["enc"], "treecnn", *map(jnp.asarray, (
        feat[2], left[2], right[2], mask[2])))
    np.testing.assert_allclose(single.numpy(), np.asarray(ref1),
                               atol=1e-4, rtol=1e-4)
    assert not enc[-1].any()                    # padded lane pools to 0


@pytest.fixture(scope="module")
def agents():
    jmeta = JMeta(TABLES, 17)
    ref = JAgent(jmeta, JAgentConfig(), seed=3)
    port = AqoraAgent(WorkloadMeta(TABLES, 17), AgentConfig(), seed=0,
                      device="cpu")
    port.load_params(params_from_numpy(
        {"actor": _np_tree(ref.actor), "critic": _np_tree(ref.critic)}))
    return ref, port


def test_act_batch_matches_reference(agents):
    ref, port = agents
    assert port.param_count() == ref.param_count() == 161549
    B, d = 8, port.space.d
    feat, left, right, mask = _states(B, 64, 26, seed=5, n_max=34)
    rng = np.random.default_rng(6)
    amask = (rng.random((B, d)) > 0.5).astype(np.float32)
    amask[:, port.space.noop_idx] = 1.0
    keys = np.stack([[0, s] for s in (1, 2, 3, 4, 5, 6, 7, 2 ** 31 - 1)]
                    ).astype(np.uint32)
    a_r, lp_r, k_r = ref.act_batch(feat, left, right, mask, amask, keys,
                                   explore=False)
    a_p, lp_p, k_p = port.act_batch(feat, left, right, mask, amask, keys,
                                    explore=False)
    np.testing.assert_array_equal(a_p, a_r)
    assert a_p.dtype == np.int32 and k_p.dtype == np.uint32
    np.testing.assert_allclose(lp_p, lp_r, atol=1e-4)
    np.testing.assert_array_equal(k_p, k_r)
    with pytest.raises(NotImplementedError, match="A5"):
        port.act_batch(feat, left, right, mask, amask, keys, explore=True)


def test_single_state_surface_matches_reference(agents):
    ref, port = agents
    feat, left, right, mask = _states(2, 64, 26, seed=8, n_max=34)
    enc = (feat[0], left[0], right[0], mask[0])
    amask = np.ones(port.space.d, np.float32)
    amask[::3] = 0.0
    np.testing.assert_allclose(port.policy_probs(enc, amask),
                               ref.policy_probs(enc, amask), atol=1e-5)
    assert abs(port.value(enc) - ref.value(enc)) < 1e-4
    a_r, lp_r = ref.act(enc, amask, explore=False)
    a_p, lp_p = port.act(enc, amask, explore=False)
    assert a_p == a_r and abs(lp_p - lp_r) < 1e-4
    key = np.array([0, 11], np.uint32)
    ak_r = ref.act_keyed(enc, amask, key, explore=False)
    ak_p = port.act_keyed(enc, amask, key, explore=False)
    assert ak_p[0] == ak_r[0] and abs(ak_p[1] - ak_r[1]) < 1e-4
    np.testing.assert_array_equal(ak_p[2], ak_r[2])
    with pytest.raises(NotImplementedError):
        port.act(enc, amask, explore=True)
