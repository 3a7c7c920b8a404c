"""The port's sampling half of the PRNG against jax.random 0.9.0: bits
and uniforms bit for bit, Gumbel values to 1e-6, categorical draws and
`choice` indices identical, over hundreds of seeded (key, logits)
pairs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

D = 172                                       # JOB's action count


def _subkeys(n, seed):
    keys = np.stack([prng.prng_key(seed * 1000 + s) for s in range(n)])
    return prng.split(keys)[:, 1]


@pytest.mark.parametrize("shape", [(), (1,), (7,), (D,), (3, 5)])
def test_bits_and_uniform_bit_equal(shape):
    for key in _subkeys(20, len(shape) + 1):
        np.testing.assert_array_equal(prng.random_bits(key, shape),
                                      np.asarray(jax.random.bits(key, shape)))
        np.testing.assert_array_equal(
            prng.uniform(key, shape), np.asarray(jax.random.uniform(key, shape)))
        tiny = float(np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(
            prng.uniform(key, shape, minval=tiny, maxval=1.0),
            np.asarray(jax.random.uniform(key, shape, minval=tiny,
                                          maxval=1.0)))
        np.testing.assert_array_equal(
            prng.uniform(key, shape, minval=-2.0, maxval=3.0),
            np.asarray(jax.random.uniform(key, shape, minval=-2.0,
                                          maxval=3.0)))


def test_stacked_keys_draw_per_key():
    subs = _subkeys(9, 3)
    np.testing.assert_array_equal(
        prng.uniform(subs, (D,)),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (D,)))(subs)))


def test_gumbel_values_close():
    """-log(-log(u)) in torch against jax.random.gumbel: within 1e-6 of
    max(1, |value|) (the two libms differ in the last bit)."""
    subs = _subkeys(200, 5)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (D,)))(subs))
    u = torch.from_numpy(prng.gumbel_uniforms(subs, D))
    got = (-torch.log(-torch.log(u))).numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("temp", [0.1, 1.0, 4.0])
def test_categorical_matches_vmapped_jax(temp):
    """240 (key, logits) pairs with -1e9-masked entries: identical draws
    to `jax.vmap(jax.random.categorical)`."""
    rng = np.random.default_rng(int(temp * 10))
    subs = _subkeys(240, int(temp * 10) + 7)
    lg = (temp * rng.standard_normal((240, D))).astype(np.float32)
    lg[rng.random((240, D)) < 0.6] = -1e9
    lg[:, 0] = 0.0                             # at least one live action
    got = prng.categorical(subs, torch.from_numpy(lg)).numpy()
    want = np.asarray(jax.vmap(jax.random.categorical)(subs, lg))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 10          # the draws do vary


@pytest.mark.parametrize("n", [5, 16, 17, 100, D, 300, 1000])
def test_cumsum_in_jax_order(n):
    rng = np.random.default_rng(n)
    for _ in range(10):
        x = rng.random(n).astype(np.float32)
        x[rng.random(n) < 0.4] = 0.0
        np.testing.assert_array_equal(prng.cumsum(x),
                                      np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_choice_matches_jax():
    """240 (key, p) pairs: the index `jax.random.choice(k, n, p=p)`
    draws."""
    rng = np.random.default_rng(11)
    subs = _subkeys(240, 13)
    for i, k in enumerate(subs):
        lg = (2.0 * rng.standard_normal(D)).astype(np.float32)
        lg[rng.random(D) < 0.5] = -1e9
        p = np.asarray(jax.nn.softmax(jnp.asarray(lg)))
        assert prng.choice(k, D, p) == int(jax.random.choice(
            k, D, p=jnp.asarray(p))), i


@pytest.mark.parametrize("seed,shape", [
    (0, (131072,)), (1, (26, 96)), (7, (96, 172)), (2 ** 31 - 1, (999, 3)),
    (12345, ()), (3, (1,))])
def test_normal_within_two_ulp(seed, shape):
    """`prng.normal` against `jax.random.normal` (fp32): bit for bit."""
    key = prng.split(prng.prng_key(seed), 3)[seed % 3]
    got = prng.normal(key, shape)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_erfinv_tails_within_two_ulp():
    """`ref.erfinv32_ref`, the erf_inv behind `prng.normal`, against
    `jax.lax.erf_inv` over every fp32 in [0.999, 1) and its negation (the
    tails of the normal), plus an even grid over (-1, 1) and the poles:
    bit for bit."""
    lo, hi = (np.float32(v).view(np.int32) for v in (0.999, 1.0))
    tail = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    x = np.concatenate([tail, -tail, np.float32([-1.0, 0.0, 1.0]),
                        np.linspace(-1, 1, 20001, dtype=np.float32)[1:-1]])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = ref.erfinv32_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
