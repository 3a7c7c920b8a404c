"""Checkpoints across ranks: `launch.train.train(mesh=, ckpt_dir=,
restore=)` on four gloo ranks of reduced dbrx-132b, against the
reference's `Checkpointer`, on the CPU.

One launch of WORLD ranks (`launch.mesh.spawn_ranks`, module scope) runs
`tests/torch_ckpt_ranks.py::rank_main` once with fp32 leaves and once
with parameters and AdamW moments in bf16 (jamba's dtypes on dbrx's
smaller model): each rank trains STEPS steps with a checkpoint every
EVERY and at the end, trains again restored from a copy whose last step
has no manifest, restores the last step with one expert leaf's last
bytes flipped, and restores a checkpoint the reference saved from its
own `init_params` and AdamW state. Everything is held bit for bit.
"""
import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ckpt_ranks as ranks_lib  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402

WORLD = 4
DTYPES = ("float32", "bfloat16")
STEPS, EVERY = ranks_lib.STEPS, ranks_lib.EVERY
REF_STEP = 5
TIMEOUT_S = 600


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference_state(dtype):
    """The reference's (params, AdamW state) of reduced dbrx-132b in
    `dtype`, from `init_params(PRNGKey(1))` and `adamw_init`, its moments
    filled (m = p / 2, v = p * p) so that every slice is its own."""
    cfg = dataclasses.replace(
        jregistry.reduced(jregistry.get_config(ranks_lib.ARCH)),
        param_dtype=dtype, opt_moment_dtype=dtype)
    p = jax.jit(lambda key: jlm.init_params(key, cfg))(
        jax.random.PRNGKey(1))         # one compile: eager takes ~10 s
    opt = jadamw_init(p, jnp.dtype(dtype))
    opt["m"] = jax.tree_util.tree_map(lambda x: x / 2, p)
    opt["v"] = jax.tree_util.tree_map(lambda x: x * x, p)
    opt["step"] = jnp.asarray(REF_STEP, jnp.int32)
    return p, opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, {dtype: the reference's state as numpy}, [each rank's
    {dtype: results}])."""
    root = tmp_path_factory.mktemp("shard_ckpt")
    refs = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the ranks train first; they wait for the reference's checkpoint
        ranked = pool.submit(spawn_ranks, ranks_lib.rank_main, WORLD,
                             (str(root), DTYPES), backend="gloo",
                             devices=["cpu"] * WORLD, timeout_s=TIMEOUT_S)
        for dtype in DTYPES:
            state = reference_state(dtype)
            JCheckpointer(root / dtype / "ref").save(
                REF_STEP, state, extra={"data_step": REF_STEP})
            refs[dtype] = jax.tree_util.tree_map(np.asarray, state)
        out = ranked.result()
    return root, refs, out


def split(path):
    return path.rsplit("/", 1)[-1] in moe.EXPERT_LEAVES


def words(a):
    """`a`, a bf16 array (ml_dtypes', or the reference's restored `|V2`)
    as its uint16 words."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16" or a.dtype.kind == "V"
    return a.view(np.uint16) if bf16 else a


def rank_slice(a, r):
    El = a.shape[1] // WORLD
    return a[:, r * El:(r + 1) * El]


def manifest(root, dtype, run):
    m = json.loads((root / dtype / run / f"step_{STEPS:08d}" /
                    "MANIFEST.json").read_text())
    return m["arrays"], m["extra"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_restores_the_ranks_checkpoint(runs, dtype):
    """The reference's `Checkpointer` restores the four ranks' last step:
    each expert leaf the ranks' slices joined on the expert axis, every
    other leaf the one every rank holds, bit for bit; bf16 leaves come
    back as the reference's `|V2` words."""
    root, refs, out = runs
    tree, step, extra = JCheckpointer(root / dtype / "a").restore(refs[dtype])
    assert step == STEPS and extra == {"data_step": STEPS}
    params = dict(_flatten(tree[0]))
    assert set(params) == set(out[0][dtype]["params"])
    bf16 = 0
    for path, got in params.items():
        mine = [o[dtype]["params"][path] for o in out]
        want = np.concatenate(mine, axis=1) if split(path) else mine[0]
        np.testing.assert_array_equal(words(got), want, err_msg=path)
        if want.dtype == np.uint16:            # a bf16 leaf
            assert got.dtype.str == "|V2", path
            bf16 += 1
    assert sum(split(p) for p in params) == 3
    assert bf16 > 3 if dtype == "bfloat16" else bf16 == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_restored_run_equals_the_unbroken_run(runs, dtype):
    """Restored from step EVERY, the run's last losses, every rank's
    parameters and its last checkpoint (every leaf of parameters, m, v
    and the step, by sha1) equal the run that did not stop."""
    root, _, out = runs
    for r, o in enumerate(out):
        got = o[dtype]
        assert got["tail"] == got["losses"][EVERY:], r
        assert got["resumed"].keys() == got["params"].keys()
        for path, a in got["params"].items():
            np.testing.assert_array_equal(got["resumed"][path], a,
                                          err_msg=f"rank {r} {path}")
    assert out[0][dtype]["losses"] == out[1][dtype]["losses"]
    assert manifest(root, dtype, "a") == manifest(root, dtype, "b")


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_checkpoint_restores_on_the_ranks(runs, dtype):
    """A checkpoint the reference saved restores on the four ranks: each
    rank's slice of every expert leaf, and every other leaf, bit for bit
    the reference's, in its dtype; `extra` as saved."""
    _, refs, out = runs
    want = dict(_flatten(refs[dtype]))
    for r, o in enumerate(out):
        got = o[dtype]
        assert got["ref_step"] == REF_STEP
        assert got["ref_extra"] == {"data_step": REF_STEP}
        assert got["ref"].keys() == want.keys()
        for path, a in want.items():
            a = words(a)
            np.testing.assert_array_equal(
                got["ref"][path], rank_slice(a, r) if split(path) else a,
                err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_torn_or_corrupt_step_is_skipped_on_every_rank(runs, dtype):
    """A last step without its manifest, or with one expert leaf's last
    slab (rank 3's) corrupted, which only the leaf's hashing rank reads
    whole: every rank restores step EVERY."""
    _, _, out = runs
    for r, o in enumerate(out):
        assert len(o[dtype]["tail"]) == STEPS - EVERY, r
        assert o[dtype]["corrupt_step"] == EVERY, r
