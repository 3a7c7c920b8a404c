"""The `shard_map` MoE dispatch across processes, one rank a card: the
port's joined mesh against the reference's `shard_map` program, on the
CPU.

Where they run: every test here runs on the CPU. The two tests that need
four ranks read one launch of four processes (`ranks`, module scope):
each rank joins the host mesh (1, 4) over gloo on the CPU
(`launch.mesh.join_host_mesh`, a `FileStore` in a temporary directory),
with OMP_NUM_THREADS=1 and 2 torch threads, and runs RANK below. The
reference cannot be given four host devices in this suite, so the ranks
are held to what the reference computes on its one-device host mesh and
to the numpy body of its `shard_map` (`np_shard_map`): the capacity of a
shard, Cl = cf * T * K / E, does not depend on tp, so the drops at tp =
1 and tp = 4 are the same. The same path on the card (NCCL over four
cards, or gloo ranks sharing one) is chip_smoke.py's shard phase.

  * `_dispatch_rank` on 4 ranks, reduced dbrx-132b in fp32, equals the
    one-device emulation at (1, 4) and `np_shard_map` within 1e-5 of the
    largest |y|; its autograd pair (`copy_to_tp`, `reduce_from_tp`) gives
    the emulation's gradients of x, of the gates and of each rank's
    experts (1e-5 of each gradient's largest |value|).
  * `BatchedServer(mesh=...)` on 4 ranks, reduced dbrx-132b and jamba at
    fp32 compute, the reference's seeded weights carried across by
    `lm_params_from_numpy(..., mesh=)`: the prefill and 4 decode steps
    against the reference's prefill under `ActivationPolicy(moe_dispatch=
    "shard_map", mesh=make_host_mesh())` and its global decode, logits
    within 1e-4 of the reference's largest |logit| (the fp32 limit of
    tests/torch_lm_cases.py), greedy tokens equal.
  * One process: each rank's seeded expert slice from `init_params(...,
    serving=True, mesh=)` bit-equal to the same slice of the whole draw,
    every other leaf equal; a one-rank gloo group serves the tokens the
    server without a mesh serves; the checks that refuse a wrong mesh.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding import act as jact  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch.mesh import Mesh, join_host_mesh, leave  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.models import blocks, lm, moe  # noqa: E402
from repro_torch.sharding import act  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from torch_lm_cases import configs, reference_params  # noqa: E402
from test_torch_layout import np_shard_map  # noqa: E402

WORLD = 4
SERVED = ("dbrx-132b", "jamba-1.5-large-398b")
B, S, STEPS = 2, 12, 4
FP32_TOL = 1e-4            # tests/torch_lm_cases.py's fp32 limit
MOE_T = 16                 # tokens through the dispatch

RANK = """
import dataclasses
import pathlib
import sys

import ml_dtypes
import numpy as np
import torch
import torch.nn.functional as F

torch.set_num_threads(2)
from repro_torch.checkpoint import lm_params_from_numpy
from repro_torch.configs import registry
from repro_torch.launch.mesh import join_host_mesh, leave
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import lm, moe
from repro_torch.sharding import act
from repro_torch.tree import flatten

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3])
mesh = join_host_mesh(rank, world, str(d), backend="gloo", device="cpu")
out = {}

# the dispatch and its gradients, reduced dbrx in fp32
def fp32(arch):
    return dataclasses.replace(registry.reduced(registry.get_config(arch)),
                               compute_dtype="float32")


cfg = fp32("dbrx-132b")
a = np.load(d / "moe.npz")
El = a["moe_wg"].shape[0] // world
x = torch.from_numpy(a["xt"]).requires_grad_(True)
g = torch.from_numpy(a["gate"]).requires_grad_(True)
w = {n: torch.from_numpy(a[n][rank * El:(rank + 1) * El].copy())
     .requires_grad_(True) for n in moe.EXPERT_LEAVES}
y = moe._dispatch_rank(x, torch.from_numpy(a["eidx"]), g, w, cfg, mesh,
                       F.silu, decode=False)
(y * torch.from_numpy(a["cot"])).sum().backward()
out["y"] = y.detach().numpy()
out["dx"], out["dgate"] = x.grad.numpy(), g.grad.numpy()
for n in moe.EXPERT_LEAVES:
    out["d" + n] = w[n].grad.numpy()
out["all_reduces"] = act.all_reduces

# the server, the reference's weights
for arch in ("dbrx-132b", "jamba-1.5-large-398b"):
    cfg = fp32(arch)
    z = np.load(d / f"{arch}.npz")
    tree = {}
    for key in z.files:
        path, _, dtype = key.partition(":")
        leaf = z[key]
        if dtype == "bf16":
            leaf = leaf.view(ml_dtypes.bfloat16)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    prompts = np.load(d / f"{arch}.prompts.npy")
    server = BatchedServer(cfg, params=lm_params_from_numpy(tree, "cpu",
                                                            mesh=mesh),
                           mesh=mesh, max_len=prompts.shape[1] + 8)
    toks, _ = server.generate(prompts, 5)
    logits = []
    with torch.inference_mode(), server.sharded():
        lg, cache = lm.prefill(server.serving, torch.from_numpy(
            prompts).long(), cfg, prompts.shape[1] + 8)
        logits.append(lg.numpy())
        for t in range(4):
            tok = torch.from_numpy(toks[:, t:t + 1]).long()
            lg, cache = lm.decode_step(server.serving, tok, cache, cfg,
                                       prompts.shape[1] + t)
            logits.append(lg.numpy())
    out[arch + ".tokens"] = toks
    out[arch + ".logits"] = np.stack(logits)
    out[arch + ".experts"] = sorted(
        {t.shape[1] for k, t in flatten(server.serving)
         if k.rsplit("/", 1)[-1] in moe.EXPERT_LEAVES})
leave(mesh)
np.savez(d / f"out{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one host, and torch's default (every core in each)
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def silu_np(a):
    return a / (1 + np.exp(-a))


def fp32(arch):
    return configs(arch, "float32")


def moe_inputs(tcfg):
    """Reduced dbrx's seeded MoE layer at fp32 and MOE_T routed tokens."""
    p = moe.init_moe(prng.prng_key(0), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    xt = rng.standard_normal((MOE_T, tcfg.d_model)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(xt) @ p["router"], -1)
    gate, eidx = moe.route(probs, tcfg.moe.top_k)
    cot = rng.standard_normal((MOE_T, tcfg.d_model)).astype(np.float32)
    return {"xt": xt, "eidx": eidx.numpy(), "gate": gate.numpy(),
            "cot": cot, **{n: p[n].numpy() for n in moe.EXPERT_LEAVES}}


def save_reference(path, tree):
    """A reference parameter tree as flat .npz entries (bf16 as uint16)."""
    flat = {}
    for k, v in flatten(jax.tree_util.tree_map(np.asarray, tree)):
        if v.dtype.name == "bfloat16":
            flat[k + ":bf16"] = v.view(np.uint16)
        else:
            flat[k] = v
    np.savez(path, **flat)


def prompts_for(jcfg):
    return np.random.default_rng(3).integers(
        2, jcfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of WORLD rank processes; returns (inputs, the ranks'
    outputs)."""
    d = tmp_path_factory.mktemp("ranks")
    _, tcfg = fp32("dbrx-132b")
    inputs = moe_inputs(tcfg)
    np.savez(d / "moe.npz", **inputs)
    for arch in SERVED:
        save_reference(d / f"{arch}.npz", reference_params(arch)[0])
        np.save(d / f"{arch}.prompts.npy", prompts_for(fp32(arch)[0]))
    env = dict(os.environ, PYTHONPATH=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(WORLD), str(d)], env=env)
             for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * WORLD, codes
    return inputs, [dict(np.load(d / f"out{r}.npz")) for r in
                    range(WORLD)]


def test_dispatch_across_ranks_matches_emulation_and_numpy(ranks):
    inputs, outs = ranks
    _, tcfg = fp32("dbrx-132b")
    E, El = tcfg.moe.n_experts, tcfg.moe.n_experts // WORLD
    x = torch.from_numpy(inputs["xt"]).requires_grad_(True)
    g = torch.from_numpy(inputs["gate"]).requires_grad_(True)
    w = {n: torch.from_numpy(inputs[n]).requires_grad_(True)
         for n in moe.EXPERT_LEAVES}
    pol = act.ActivationPolicy(moe_dispatch="shard_map", tp_size=WORLD,
                               mesh=Mesh(("data", "model"), (1, WORLD)))
    y = moe._dispatch_sharded(x, torch.from_numpy(inputs["eidx"]), g, w,
                              tcfg, pol, torch.nn.functional.silu)
    (y * torch.from_numpy(inputs["cot"])).sum().backward()
    want = np_shard_map(inputs["xt"], inputs["eidx"], inputs["gate"],
                        *(inputs[n] for n in moe.EXPERT_LEAVES), 1, WORLD,
                        tcfg.moe.capacity_factor, silu_np)
    top = np.abs(want).max()
    emulated = y.detach().numpy()
    assert np.abs(emulated - want).max() <= 1e-5 * top
    for r, out in enumerate(outs):
        assert int(out["all_reduces"]) == 1
        assert np.abs(out["y"] - want).max() <= 1e-5 * top, r
        assert np.abs(out["y"] - emulated).max() <= 1e-5 * top, r
        for name, got, full in (("dx", out["dx"], x.grad),
                                ("dgate", out["dgate"], g.grad)):
            full = full.numpy()
            assert np.abs(got - full).max() <= 1e-5 * np.abs(full).max(), \
                (r, name)
        for n in moe.EXPERT_LEAVES:
            full = w[n].grad.numpy()[r * El:(r + 1) * El]
            scale = max(np.abs(w[n].grad.numpy()).max(), 1e-30)
            assert np.abs(out["d" + n] - full).max() <= 1e-5 * scale, (r, n)
    assert E % WORLD == 0


def reference_serve(arch):
    """The reference's prefill under the shard_map policy on its host
    mesh, then 4 greedy decode steps (global, no-drop): logits (5, B, V)
    and tokens (B, 5)."""
    jp, _ = reference_params(arch)
    jcfg, _ = fp32(arch)
    prompts = prompts_for(jcfg)
    pol = jact.ActivationPolicy(moe_dispatch="shard_map",
                                mesh=jmesh.make_host_mesh())
    with jact.policy(pol):
        lg, cache = jlm.prefill(jp, jnp.asarray(prompts), jcfg, S + 8)
    dec = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, t, c, jcfg, pos))
    logits, toks = [np.asarray(lg)], [np.asarray(lg).argmax(-1)]
    for t in range(STEPS):
        tok = jnp.asarray(toks[-1][:, None].astype(np.int32))
        lg, cache = dec(jp, tok, cache, jnp.int32(S + t))
        logits.append(np.asarray(lg))
        toks.append(np.asarray(lg).argmax(-1))
    return np.stack(logits), np.stack(toks, 1)


@pytest.mark.parametrize("arch", SERVED)
def test_server_across_ranks_matches_reference(ranks, arch):
    _, outs = ranks
    want_logits, want_toks = reference_serve(arch)
    limit = FP32_TOL * np.abs(want_logits).max()
    _, tcfg = fp32(arch)
    for r, out in enumerate(outs):
        assert out[arch + ".experts"].tolist() == \
            [tcfg.moe.n_experts // WORLD]
        np.testing.assert_array_equal(out[arch + ".tokens"], want_toks,
                                      err_msg=f"rank {r}")
        got = out[arch + ".logits"]
        assert got.shape == want_logits.shape
        assert np.abs(got - want_logits).max() <= limit, r
        np.testing.assert_array_equal(got, outs[0][arch + ".logits"])


def words(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_seeded_expert_slices_equal_the_whole_draw(arch):
    """dbrx's one MoE layer a superblock; llama4's four, each beside a
    shared expert whose MLP leaves are drawn whole."""
    cfg = registry.reduced(registry.get_config(arch))
    key = prng.prng_key(7)
    whole = dict(flatten(lm.init_params(key, cfg, device="cpu",
                                        serving=True)))
    El = cfg.moe.n_experts // WORLD
    for j in range(WORLD):
        mesh = Mesh(("data", "model"), (1, WORLD), rank=j)
        mine = dict(flatten(lm.init_params(key, cfg, device="cpu",
                                           serving=True, mesh=mesh)))
        assert mine.keys() == whole.keys()
        for path, t in mine.items():
            want = whole[path]
            if path.rsplit("/", 1)[-1] in moe.EXPERT_LEAVES:
                want = want[:, j * El:(j + 1) * El]
            assert t.shape == want.shape and t.dtype == want.dtype, path
            assert torch.equal(words(t), words(want)), (j, path)


def test_one_rank_mesh_serves_as_without_mesh(tmp_path):
    """A joined (1, 1) mesh: the rank's dispatch holds every expert, its
    all_reduce is the identity, and its tokens are the server's without a
    mesh; a mesh the experts do not divide, a dispatch other than
    shard_map and a descriptor mesh are refused."""
    _, cfg = fp32("dbrx-132b")
    prompts = prompts_for(fp32("dbrx-132b")[0])
    plain, _ = BatchedServer(cfg, max_len=S + 8, device="cpu").generate(
        prompts, 5)
    mesh = join_host_mesh(0, 1, str(tmp_path), backend="gloo", device="cpu")
    try:
        act.all_reduces = 0
        server = BatchedServer(cfg, max_len=S + 8, mesh=mesh)
        assert server.device.type == "cpu"
        assert server.policy.tp_size == 1 and server.policy.dp_size == 1
        got, _ = server.generate(prompts, 5)
        np.testing.assert_array_equal(got, plain)
        moe_layers = cfg.n_layers
        assert act.all_reduces == moe_layers * (1 + 5)   # prefill, 5 steps
        with pytest.raises(ValueError, match="E/tp"):
            BatchedServer(cfg, params=lm.init_params(
                prng.prng_key(0), cfg, device="cpu", mesh=Mesh(
                    ("data", "model"), (1, 2), rank=1)),
                mesh=mesh)
        x = torch.zeros((1, 4, cfg.d_model))
        with act.policy(act.ActivationPolicy(moe_dispatch="global",
                                             mesh=mesh)), \
                pytest.raises(ValueError, match="shard_map"):
            moe.apply_moe(blocks.superblock(server.serving["stack"], 0)
                          ["layer0"]["ffn"], x, cfg)
        with pytest.raises(ValueError, match="joined"):
            BatchedServer(cfg, mesh=Mesh(("data", "model"), (1, 1)),
                          device="cpu")
    finally:
        leave(mesh)
