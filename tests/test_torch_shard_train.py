"""The LM train step across ranks through the `shard_map` MoE dispatch:
four gloo ranks against the reference's own four-device program, on the
CPU.

One launch of six processes (`runs`, module scope), started together:

  * the reference, in two processes (jamba's case alone in one):
    `repro.launch.steps.make_train_step(cfg, total_steps=TOTAL)`, jitted,
    under `ActivationPolicy(moe_dispatch="shard_map",
    mesh=make_host_mesh(), tp_size=4)`; each process sets jax's
    `jax_num_cpu_devices` to 4 before any device is made (this process
    keeps its one device), so that the mesh is (1, 4) and the
    `shard_map` runs four shards; the state is replicated on that mesh
    and the outputs pinned to the same sharding, so that the second step
    reuses the first's compile;
  * four ranks of the port, each joined to the host mesh (1, 4) over gloo
    on the CPU (`launch.mesh.join_host_mesh`), each holding its E/4
    experts of every expert leaf (`checkpoint.lm_params_from_numpy(...,
    mesh=)`) and running `repro_torch.launch.steps.make_train_step(cfg,
    total_steps=TOTAL, mesh=mesh)`.

Both start from the reference's seeded weights and take STEPS steps on
the same numpy batches. The configs: reduced dbrx-132b, reduced
llama4-scout and reduced jamba-1.5-large cut to one superblock (8
layers), at compute_dtype="float32"; reduced dbrx-132b once more for one
step at its own bf16.

Limits (fp32 compute), with what was measured:
  * loss and grad_norm within 1e-5 of the reference's (the ranks sum
    each expert leaf's squares in another order than one device;
    measured: at most 5e-7);
  * AdamW's m and v, every rank's leaves held whole and its expert slice
    against the same slice of the reference's, within 1e-5 of the leaf's
    largest |value| (measured: 2.2e-6);
  * the parameters within 1e-5 of the leaf's largest |value| plus
    STEP_RTOL of the learning rate summed over the steps, the limit of
    tests/test_torch_train_lm.py: Adam divides each gradient by its own
    size, so an element whose gradient is tiny beside its leaf's largest
    takes a step known only to that share (measured: 0.90 of the limit,
    at an element of dbrx's embedding whose m is 7e-7 of the leaf's
    largest and whose two values differ by 7%);
  * jamba keeps its parameters and moments in bf16: a bf16 leaf within
    2^-7 of each element's |value| plus 2^-6 of the leaf's largest
    (tests/test_torch_train_lm.py's bf16 limits).
Across ranks: the losses, norms and every leaf held whole (parameters,
m, v) bit-equal after every step. Each step makes exactly 2 M psums (the
forward's and the remat re-forward's, M MoE layers), 2 M cotangent sums
(each MoE layer's input and gates) and one all_reduce of the expert
leaves' sums of squares.

At bf16 compute (one step, lr 0): XLA's CPU and torch round bf16 at
other places, so the loss within BF16_LOSS_RTOL and grad_norm within
BF16_NORM_RTOL of the reference's (measured: 3.3e-5 and 8.8e-4), and of
the port's own tp = 1 step (measured: equal). The ranks sum the
repeated input's cotangent over a token's K picks before the ranks,
where the reference and tp = 1 sum over the ranks first; at top-2 each
token's two picks meet in one addition either way (a rank adds zeros
for the other's), so the orders round alike here; at dbrx's published
top-4 they differ (chip_smoke.py's shard phase measures it).

The mesh-aware optimizer pieces alone: `global_norm` of every rank's
slices equal to the whole tree's within 1e-6, and `compress_grads`'s
dequantized slices and error state bit-equal to the same slices of the
whole tree's (the whole leaf's scale from one all_reduce of the ranks'
largest magnitudes).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint import (Checkpointer,  # noqa: E402
                                    lm_params_from_numpy)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import Mesh, join_host_mesh, leave  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.optim import adamw_init, global_norm  # noqa: E402
from repro_torch.optim.compress import compress_grads  # noqa: E402
from repro_torch.sharding import act  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_shard import save_reference  # noqa: E402

WORLD = 4
# (arch, layers: None keeps the reduced config's 2 superblocks)
CASES = {"dbrx-132b": None, "llama4-scout-17b-a16e": None,
         "jamba-1.5-large-398b": 8}
BF16_ARCH = "dbrx-132b"
SLOW_ARCH = "jamba-1.5-large-398b"   # the reference's longest compile
B, S, STEPS, TOTAL = 2, 32, 3, 4
RTOL = 1e-5
STEP_RTOL = 1e-2
BF16_OWN, BF16_LEAF = 2 ** -7, 2 ** -6
BF16_LOSS_RTOL = 1e-3
BF16_NORM_RTOL = 1e-2
TIMEOUT_S = 900

CONFIG = """
import dataclasses
import ml_dtypes
import numpy as np


def cut(cfg, layers, dtype):
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def load(path):
    tree = {}
    z = np.load(path)
    for key in z.files:
        name, _, dtype = key.partition(":")
        leaf = z[key]
        if dtype == "bf16":
            leaf = leaf.view(ml_dtypes.bfloat16)
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree
"""

REFERENCE = CONFIG + """
import os
import sys
import pathlib

import jax

jax.config.update("jax_num_cpu_devices", 4)
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import registry
from repro.launch import mesh as jmesh
from repro.launch import steps
from repro.optim import adamw_init
from repro.sharding import act

d, total = pathlib.Path(sys.argv[1]), int(sys.argv[2])
cases = eval(sys.argv[3])
mesh = jmesh.make_host_mesh()
assert mesh.shape == {"data": 1, "model": 4}, mesh.shape
rep = NamedSharding(mesh, P())
pol = act.ActivationPolicy(moe_dispatch="shard_map", mesh=mesh, tp_size=4)
for arch, layers, dtype, n in cases:
    cfg = cut(registry.reduced(registry.get_config(arch)), layers, dtype)
    p = jax.tree_util.tree_map(jnp.asarray, load(d / f"params.{arch}.npz"))
    st = adamw_init(p, jnp.dtype(cfg.opt_moment_dtype))
    p, st = jax.device_put((p, st), rep)
    step = jax.jit(steps.make_train_step(cfg, total_steps=total),
                   out_shardings=rep)
    toks = np.load(d / "tokens.npy")
    out = {}
    with mesh, act.policy(pol):
        for s in range(n):
            p, st, m = step(p, st, {"tokens": jax.device_put(
                jnp.asarray(toks[s]), rep)})
            for k in ("loss", "grad_norm", "lr"):
                out[f"{k}/{s}"] = np.asarray(m[k], np.float32)
            for name, tree in (("p", p), ("m", st["m"]), ("v", st["v"])):
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        tree)[0]:
                    key = "/".join(k.key for k in path)
                    out[f"{name}{s}/{key}"] = np.asarray(leaf, np.float32)
    np.savez(d / f"ref.{arch}.{dtype}.npz", **out)
"""

RANK = CONFIG + """
import sys
import pathlib

import torch

torch.set_num_threads(1)
from repro_torch.checkpoint import lm_params_from_numpy
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch.mesh import join_host_mesh, leave
from repro_torch.optim import adamw_init, global_norm
from repro_torch.optim.compress import compress_grads
from repro_torch.sharding import act
from repro_torch.tree import flatten

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3])
total, cases = int(sys.argv[4]), eval(sys.argv[5])
mesh = join_host_mesh(rank, world, str(d), backend="gloo", device="cpu")
toks = np.load(d / "tokens.npy")
for arch, layers, dtype, n in cases:
    cfg = cut(registry.reduced(registry.get_config(arch)), layers, dtype)
    params = lm_params_from_numpy(load(d / f"params.{arch}.npz"), "cpu",
                                  mesh=mesh)
    out = {}
    if dtype == "float32" and arch == cases[0][0]:
        # the optimizer pieces alone, on the weights as a gradient tree
        out["unit/norm"] = global_norm(params, mesh).numpy()
        dq, err = compress_grads(params, mesh=mesh)
        for name, tree in (("dq", dq), ("err", err)):
            for path, leaf in flatten(tree):
                out[f"unit/{name}/{path}"] = leaf.float().numpy()
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    step = steps.make_train_step(cfg, total_steps=total, mesh=mesh)
    for s in range(n):
        act.all_reduces = act.cotangent_all_reduces = 0
        act.stat_all_reduces = 0
        params, opt, m = step(params, opt,
                              {"tokens": torch.from_numpy(toks[s])})
        out[f"counts/{s}"] = np.array([act.all_reduces,
                                       act.cotangent_all_reduces,
                                       act.stat_all_reduces])
        for k in ("loss", "grad_norm", "lr"):
            out[f"{k}/{s}"] = np.asarray(float(m[k]), np.float32)
        for name, tree in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
            for path, leaf in flatten(tree):
                out[f"{name}{s}/{path}"] = leaf.float().clone().numpy()
    np.savez(d / f"out{rank}.{arch}.{dtype}.npz", **out)
leave(mesh)
"""


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's own torch work (the suite runs
    six workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cut(cfg, layers, dtype):
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def tcfg_of(arch, dtype="float32"):
    return cut(registry.reduced(registry.get_config(arch)), CASES[arch],
               dtype)


def jcfg_of(arch, dtype="float32"):
    return cut(jregistry.reduced(jregistry.get_config(arch)), CASES[arch],
               dtype)


def cases():
    """(arch, layers, compute dtype, steps) in the order both sides run
    them."""
    return [(a, CASES[a], "float32", STEPS) for a in CASES] + \
        [(BF16_ARCH, CASES[BF16_ARCH], "bfloat16", 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and WORLD ranks, launched together. Returns
    ({arch: numpy params}, tokens, {(arch, dtype): reference outputs},
    {(arch, dtype): [rank outputs]})."""
    d = tmp_path_factory.mktemp("shard_train")
    params = {}
    for arch in CASES:
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg_of(arch))
        params[arch] = jax.tree_util.tree_map(np.asarray, jp)
        save_reference(d / f"params.{arch}.npz", jp)
    toks = np.random.default_rng(5).integers(
        2, jcfg_of(BF16_ARCH).vocab_size, (STEPS, B, S)).astype(np.int32)
    np.save(d / "tokens.npy", toks)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    listed = repr(cases())
    # the reference in two processes: jamba's compile (~60 s alone) beside
    # the other cases'
    slow = [c for c in cases() if c[0] == SLOW_ARCH]
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d), str(TOTAL), repr(part)],
        env=dict(env, JAX_PLATFORMS="cpu"))
        for part in (slow, [c for c in cases() if c not in slow])]
    procs += [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                                str(WORLD), str(d), str(TOTAL), listed],
                               env=env) for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * (2 + WORLD), codes
    ref, ranks = {}, {}
    for arch, _, dtype, _ in cases():
        ref[arch, dtype] = dict(np.load(d / f"ref.{arch}.{dtype}.npz"))
        ranks[arch, dtype] = [dict(np.load(d / f"out{r}.{arch}.{dtype}.npz"))
                              for r in range(WORLD)]
    return params, toks, ref, ranks


def split(path):
    return path.rsplit("/", 1)[-1] in moe.EXPERT_LEAVES


def rank_slice(a, r):
    """Rank r's experts of a stacked expert leaf (L, E, ...)."""
    El = a.shape[1] // WORLD
    return a[:, r * El:(r + 1) * El]


def leaves_at(out, name, s):
    head = f"{name}{s}/"
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


def check_tree(want, got, r, bf16, what, slack=0.0):
    """Rank r's leaves `got` against the reference's whole leaves `want`
    (each expert leaf against rank r's slice of it)."""
    assert want.keys() == got.keys(), what
    for path, a in want.items():
        if split(path):
            a = rank_slice(a, r)
        b = got[path]
        assert a.shape == b.shape, (what, path)
        top = max(float(np.abs(a).max()), 1e-30)
        limit = slack + (BF16_OWN * np.abs(a) + BF16_LEAF * top if bf16
                         else RTOL * top)
        assert np.all(np.abs(a - b) <= limit), \
            f"{what} rank {r} {path}: {float(np.abs(a - b).max())} of {top}"


@pytest.mark.parametrize("arch", list(CASES))
def test_train_steps_across_ranks_match_reference(runs, arch):
    _, _, ref, ranks = runs
    want, outs = ref[arch, "float32"], ranks[arch, "float32"]
    bf16 = jcfg_of(arch).param_dtype == "bfloat16"
    lr_sum = 0.0
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            w = float(want[f"{k}/{s}"])
            for r, out in enumerate(outs):
                assert abs(float(out[f"{k}/{s}"]) - w) <= RTOL * abs(w), \
                    (k, s, r)
        assert all(float(o[f"lr/{s}"]) == float(want[f"lr/{s}"])
                   for o in outs)
        lr_sum += float(want[f"lr/{s}"])
        for r, out in enumerate(outs):
            for name in ("m", "v"):
                check_tree(leaves_at(want, name, s), leaves_at(out, name, s),
                           r, bf16, f"{arch} {name} step {s}")
            check_tree(leaves_at(want, "p", s), leaves_at(out, "p", s), r,
                       bf16, f"{arch} params step {s}",
                       slack=STEP_RTOL * lr_sum)
    assert float(want["lr/0"]) == 0.0 and lr_sum > 0


@pytest.mark.parametrize("arch", list(CASES))
def test_leaves_held_whole_stay_equal_across_ranks(runs, arch):
    _, _, _, ranks = runs
    outs = ranks[arch, "float32"]
    for key, first in outs[0].items():
        if key.startswith("counts/"):
            continue
        for r, out in enumerate(outs[1:], 1):
            if split(key):
                assert out[key].shape == first.shape, (key, r)
            else:
                np.testing.assert_array_equal(out[key], first,
                                              err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("arch", list(CASES))
def test_all_reduces_a_step(runs, arch):
    """The forward's psums and the remat re-forward's (one a MoE layer
    each), the cotangent sums of each MoE layer's input and gates, and
    one all_reduce of the expert leaves' sums of squares."""
    _, _, _, ranks = runs
    cfg = tcfg_of(arch)
    M = cfg.n_superblocks * sum(s.ffn == "moe" for s in cfg.block_pattern)
    for r, out in enumerate(ranks[arch, "float32"]):
        for s in range(STEPS):
            assert out[f"counts/{s}"].tolist() == [2 * M, 2 * M, 1], (r, s)


def test_bf16_step_across_ranks_matches_reference_and_one_rank(runs):
    """One step at the config's own bf16: the ranks' loss and grad_norm
    against the reference's four-device step and the port's tp = 1 step
    (no mesh, every expert) on the same batch."""
    params, toks, ref, ranks = runs
    want, outs = ref[BF16_ARCH, "bfloat16"], ranks[BF16_ARCH, "bfloat16"]
    cfg = tcfg_of(BF16_ARCH, "bfloat16")
    p = lm_params_from_numpy(params[BF16_ARCH], "cpu")
    opt = adamw_init(p, getattr(torch, cfg.opt_moment_dtype))
    _, _, one = tsteps.make_train_step(cfg, total_steps=TOTAL)(
        p, opt, {"tokens": torch.from_numpy(toks[0])})
    for k, rtol in (("loss", BF16_LOSS_RTOL), ("grad_norm", BF16_NORM_RTOL)):
        w, o = float(want[f"{k}/0"]), float(one[k])
        assert abs(o - w) <= rtol * abs(w), (k, "tp=1", o, w)
        for r, out in enumerate(outs):
            g = float(out[f"{k}/0"])
            assert g == float(outs[0][f"{k}/0"]), (k, r)
            assert abs(g - w) <= rtol * abs(w), (k, r, g, w)
            assert abs(g - o) <= rtol * abs(o), (k, r, g, o)


def test_global_norm_and_compress_across_ranks_equal_whole(runs):
    """On the first case's weights as a gradient tree: every rank's
    mesh-aware `global_norm` equals the whole tree's within 1e-6 (the
    expert leaves' squares summed in another order); its
    `compress_grads` slices equal the whole tree's bit for bit."""
    params, _, _, ranks = runs
    arch = next(iter(CASES))
    whole = lm_params_from_numpy(params[arch], "cpu")
    norm = float(global_norm(whole))
    dq, err = compress_grads(whole)
    want = {f"dq/{k}": v.float().numpy() for k, v in flatten(dq)}
    want.update({f"err/{k}": v.float().numpy() for k, v in flatten(err)})
    for r, out in enumerate(ranks[arch, "float32"]):
        assert abs(float(out["unit/norm"]) - norm) <= 1e-6 * norm, r
        for key, a in want.items():
            got = out[f"unit/{key}"]
            np.testing.assert_array_equal(
                got, rank_slice(a, r) if split(key) else a,
                err_msg=f"{key} rank {r}")
    assert any(split(k) for k in want)


def test_count_train_counts_one_ranks_step():
    """`dryrun.count_train` on `meta`: a rank's step with a descriptor
    mesh (as if joined) is the same for every rank, and holds the
    experts' parameters, gradients and moments a quarter as large as the
    step without a mesh."""
    cfg = registry.reduced(registry.get_config("dbrx-132b"))
    whole = dryrun.count_train(cfg, B, S)
    peaks = [dryrun.count_train(cfg, B, S, mesh=Mesh(
        ("data", "model"), (1, WORLD), rank=j)).peak_live_bytes
        for j in range(WORLD)]
    assert len(set(peaks)) == 1
    experts = sum(t.numel() * t.element_size() for path, t in flatten(
        lm.init_params(None, cfg, device="meta")) if split(path))
    # at least the parameters, m and v of 3/4 of the experts fewer
    assert whole.peak_live_bytes - peaks[0] >= 3 * experts * 3 // 4


def test_train_with_one_rank_mesh_trains_as_without(tmp_path):
    """`launch.train.train` on a joined (1, 1) mesh: the rank holds every
    expert and its all_reduces are the identity, so its losses equal the
    run's without a mesh. Its checkpoint restores without a mesh to the
    parameters it returned, and the run without a mesh's checkpoint,
    restored and saved again on the mesh (the expert leaves written as the
    ranks write them), gives the same files byte for byte, the manifests
    equal but for their time. (The two runs' states are not: at bf16
    compute the mesh's dispatch rounds the expert leaves' and the
    embedding's gradients in another order on the CPU.) A descriptor mesh
    is refused."""
    kw = dict(smoke=True, steps=2, global_batch=2, seq_len=16,
              log_every=0, device="cpu")
    plain_dir, mesh_dir = tmp_path / "plain", tmp_path / "mesh"
    params, plain = ttrain.train("dbrx-132b", ckpt_dir=str(plain_dir), **kw)
    like = [params, adamw_init(params)]
    mesh = join_host_mesh(0, 1, str(tmp_path), backend="gloo", device="cpu")
    try:
        act.all_reduces = 0
        got_params, got = ttrain.train("dbrx-132b", mesh=mesh,
                                       ckpt_dir=str(mesh_dir), **kw)
        assert got == plain
        assert act.all_reduces > 0
        state, step, _ = Checkpointer(plain_dir, mesh=mesh).restore(like)
        assert step == 2
        Checkpointer(tmp_path / "again", mesh=mesh).save(
            step, state, extra={"data_step": 2})
    finally:
        leave(mesh)
    restored, _, _ = Checkpointer(mesh_dir).restore(like)
    for (path, a), (_, b) in zip(flatten(got_params),
                                 flatten(restored["0"])):
        assert torch.equal(a, b), path
    step_dir = pathlib.Path("step_00000002")
    files = sorted(p.name for p in (plain_dir / step_dir).iterdir())
    assert files == sorted(p.name for p in
                           (tmp_path / "again" / step_dir).iterdir())
    assert sum(f.endswith("moe_wg.npy") for f in files) == 3
    for f in files:
        a = (plain_dir / step_dir / f).read_bytes()
        b = (tmp_path / "again" / step_dir / f).read_bytes()
        if f == "MANIFEST.json":
            a, b = json.loads(a), json.loads(b)
            a.pop("time"), b.pop("time")
        assert a == b, f
    with pytest.raises(ValueError, match="joined"):
        ttrain.train("dbrx-132b", mesh=Mesh(("data", "model"), (1, 1)),
                     **kw)


def test_split_leaves_names_the_expert_leaves(tmp_path):
    """`sharding.act.split_leaves`: on a joined mesh, the paths of the
    expert leaves in sorted-leaf order (none for a model without MoE);
    without a mesh or with a descriptor mesh, none."""
    moe_params = lm.init_params(
        None, registry.reduced(registry.get_config("dbrx-132b")),
        device="meta")
    dense = lm.init_params(
        None, registry.reduced(registry.get_config("qwen3-8b")),
        device="meta")
    want = [path for path, _ in flatten(moe_params) if split(path)]
    assert len(want) == 3
    mesh = join_host_mesh(0, 1, str(tmp_path), backend="gloo", device="cpu")
    try:
        assert act.split_leaves(moe_params, mesh) == want
        assert act.split_leaves(dense, mesh) == []
    finally:
        leave(mesh)
    assert act.split_leaves(moe_params, None) == []
    assert act.split_leaves(moe_params, Mesh(("data", "model"), (1, WORLD),
                                             rank=1)) == []
