"""Seeded parity of the port's LM paths with the JAX package's, on the CPU.

* `kernels.ref`'s plain `jax.random` (the threefry kernel's plain
  version, through the `kernels.threefry` wrappers): `normal` and
  `gumbel` equal `jax.random.normal` and `jax.random.gumbel` bit for bit
  on odd shapes, on stacks of keys (against `jax.vmap`), with a stddev,
  in bf16, and on an offset slice against the whole draw; its FMA rounds
  once where a double rounding through fp64 would not;
  `categorical` on one key over (B, V), V odd, equals
  `jax.random.categorical`.
* `lm.init_params(prng_key(s))` equals `repro.models.lm.init_params(
  PRNGKey(s))` leaf for leaf, bit for bit (compared as integers: bf16
  leaves as 16-bit words), for all ten reduced architectures at seeds 0
  and 7, `mamba_A_log` (XLA's fp32 log, an ulp from the correctly rounded
  one at 7) included.
* `launch.train.train` from a seed alone gives the reference driver's
  losses within LOSS_RTOL (the train tests' loss limit; measured: 3.4e-6
  in the reduced config's own bf16 compute). Both drivers read the same
  batches: the data pipeline is a verbatim copy.

The sampled server's tokens are in tests/test_torch_lm_serve.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ref, threefry  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

LOSS_RTOL = 1e-5
SHAPES = [(), (1,), (7,), (4097, 101), (3, 5, 7)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def words(x):
    """An array's elements as unsigned integers of its width."""
    if torch.is_tensor(x):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return x.view(f"u{x.dtype.itemsize}")


def draw(fn, key, shape, **kw):
    n = int(np.prod(shape, dtype=np.int64))
    return fn(np.asarray(key, np.uint32), n, device="cpu", **kw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_normal_and_gumbel_bit_equal(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = jax.random.normal(key, shape, jnp.float32)
    got = draw(threefry.normal, key, shape)
    np.testing.assert_array_equal(words(got).reshape(shape), words(want))
    want = jax.random.gumbel(key, shape, jnp.float32)
    got = draw(threefry.gumbel, key, shape)
    np.testing.assert_array_equal(words(got).reshape(shape), words(want))


def test_stacked_keys_stddev_bf16_and_offsets():
    keys = jax.random.split(jax.random.PRNGKey(3), 6).reshape(2, 3, 2)
    shape = (33, 17)
    want = jax.vmap(jax.vmap(
        lambda k: 0.1 * jax.random.normal(k, shape)))(keys)
    got = draw(threefry.normal, keys, shape, stddev=0.1)
    np.testing.assert_array_equal(words(got).reshape(want.shape), words(want))
    got = draw(threefry.normal, keys, shape, stddev=0.1, dtype=torch.bfloat16)
    np.testing.assert_array_equal(words(got).reshape(want.shape),
                                  words(want.astype(jnp.bfloat16)))
    want = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, shape)))(keys)
    got = draw(threefry.gumbel, keys, shape)
    np.testing.assert_array_equal(words(got).reshape(want.shape), words(want))
    key = prng.prng_key(11)
    n = 3 * threefry.PLAIN_CHUNK + 5      # the plain version's slices too
    whole = threefry.normal(key, n, device="cpu")
    for at, m in ((0, 5), (n - 7, 7), (threefry.PLAIN_CHUNK - 3, 9)):
        part = threefry.normal(key, m, device="cpu", offset=at)
        np.testing.assert_array_equal(words(part), words(whole[at:at + m]))
        part = threefry.gumbel(key, m, device="cpu", offset=at)
        np.testing.assert_array_equal(
            words(part), words(threefry.gumbel(key, n, device="cpu")[at:
                                                                    at + m]))


def test_fma_rounds_once():
    """(1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies on an fp32 midpoint; a term
    far below fp64's ulp decides which way the FMA rounds, where rounding
    the fp64 sum to fp32 would take the even neighbour either way."""
    a = torch.full((3,), 1 + 2 ** -12, dtype=torch.float32)
    c = torch.tensor([2.0 ** -60, -2.0 ** -60, 0.0])
    got = ref._fma(a, a, c).double() - 1
    assert got.tolist() == [2 ** -11 + 2 ** -23, 2 ** -11, 2 ** -11]
    got = ref._fma(-a, a, -c).double() + 1
    assert got.tolist() == [-2 ** -11 - 2 ** -23, -2 ** -11, -2 ** -11]


@pytest.mark.parametrize("B, V", [(4, 513), (1, 151), (8, 1001)])
def test_categorical_one_key_over_the_batch(B, V):
    for seed in range(10):
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        logits = np.random.default_rng(seed).standard_normal(
            (B, V)).astype(np.float32) * 3
        want = jax.random.categorical(key, jnp.asarray(logits))
        got = threefry.categorical(np.asarray(key, np.uint32),
                                   torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_init_params_bit_equal_to_reference(arch):
    cfg = registry.reduced(registry.get_config(arch))
    jcfg = jregistry.reduced(jregistry.get_config(arch))
    for seed in (0, 7):
        want = flatten(jlm.init_params(jax.random.PRNGKey(seed), jcfg))
        got = flatten(lm.init_params(prng.prng_key(seed), cfg, device="cpu"))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
            np.testing.assert_array_equal(words(g), words(w), err_msg=path)


def test_mamba_a_log_is_xlas_log():
    """log(7) in fp32: XLA's is an ulp from the correctly rounded value,
    and the port's `mamba_A_log` holds XLA's."""
    cfg = registry.reduced(registry.get_config("falcon-mamba-7b"))
    a_log = lm.init_params(prng.prng_key(0), cfg, device="cpu")[
        "stack"]["layer0"]["mixer"]["mamba_A_log"][0, 0]
    want = np.asarray(jnp.log(jnp.arange(1, 9, dtype=jnp.float32)))
    np.testing.assert_array_equal(words(a_log), words(want))
    assert a_log[6].item() != float(np.float32(np.log(7.0)))


def test_train_driver_from_a_seed_matches_reference():
    kw = dict(smoke=True, steps=2, seq_len=32, seed=0, log_every=0)
    _, want = jtrain.train("qwen3-8b", **kw)
    _, got = ttrain.train("qwen3-8b", device="cpu", **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, want)
