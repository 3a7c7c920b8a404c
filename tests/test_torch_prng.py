"""The port's numpy threefry keys against jax.random, bit for bit."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.rollout import as_key as jax_as_key  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.rollout import as_key  # noqa: E402

SEEDS = [0, 1, 42, 7919, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32 + 7, 2 ** 33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_equal(seed):
    ref = np.asarray(jax.random.PRNGKey(seed), np.uint32)
    np.testing.assert_array_equal(prng.prng_key(seed), ref)
    np.testing.assert_array_equal(as_key(seed), jax_as_key(seed))
    np.testing.assert_array_equal(as_key(np.int64(seed)), ref)
    for num in (2, 5):
        np.testing.assert_array_equal(
            prng.split(ref, num), np.asarray(jax.random.split(ref, num)))


def test_lane_chain_matches_vmapped_split():
    keys = np.stack([prng.prng_key(s) for s in SEEDS])
    for _ in range(3):                         # three decisions per lane
        pairs = np.asarray(jax.vmap(lambda k: jax.random.split(k, 2))(keys))
        np.testing.assert_array_equal(prng.split(keys), pairs)
        keys = pairs[:, 0]
    raw = np.array([3, 4], np.uint32)
    np.testing.assert_array_equal(as_key(raw), jax_as_key(raw))
