"""The layout re-optimizer's plan space and the policy-driven model paths
against the JAX package's, on the CPU.

Knobs and search (exact: pure arithmetic and strings):
* `LayoutPlan.name()`, `neighbors("train"/"decode")`, and `predict_delta`'s
  text and multipliers for every one-flip neighbour of three layouts;
* `climb` gives the same logs in both packages when both call a stub
  `evaluate` that reads one table of records.

Policy paths, each under `act.policy(ActivationPolicy(...))` in both
packages, on reduced configs in fp32 compute with the reference's seeded
weights carried across (`checkpoint.lm_params_from_numpy`):
* `ce_chunk`, `remat` ("full", "dots", "none"), the block-local and the
  `shard_map` MoE dispatch: the loss within LOSS_RTOL and every gradient
  leaf within LEAF_RTOL of its largest |value| (the training tests'
  limits: fp32 sums in another order; remat under "dots"); each remat
  mode equals the port's no-remat step bit for bit (the same ops run
  again);
* `attn_scores_bf16` on reduced minicpm3-4b (MLA) and llama4 (chunked):
  the scores are rounded to bf16 on both sides, and an fp32 score that
  the two frameworks' sums leave a bit apart rounds, now and then, to
  neighbouring bf16 values (2^-8 relative): the loss within LOSS_RTOL
  (measured 7.6e-8) and each gradient within BF16_LEAF_RTOL of its
  largest (measured 2.5e-3 and 5.8e-3);
* `attn_remat`: `mha` on the blockwise path (Sk = 2304 > 2048) for a
  chunked mask and for MLA's narrower v, against the reference's `mha`
  under the same policy (output and q/k/v gradients within LEAF_RTOL)
  and bit for bit against the port's own without it;
* `mla_absorb`: reduced minicpm3-4b's decode logits (prefill, then 4
  steps) within LOGIT_RTOL of the reference's largest |logit|;
* the `shard_map` dispatch at (dp, tp) = (2, 4) against a numpy
  transcription of the reference's per-shard `body`
  (`repro/models/moe.py:176-199`), within 1e-5 of the largest |y|.

`compressed_psum` on a one-rank gloo group (a `HashStore`) equals the
reference's inside `shard_map` on the one-device host mesh, bit for bit,
and across four gloo ranks (processes) the reference's arithmetic in
numpy, bit for bit.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.adapt import knobs as jknobs  # noqa: E402
from repro.adapt import search as jsearch  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.sharding import act as jact  # noqa: E402
from repro_torch.adapt import knobs, search  # noqa: E402
from repro_torch.checkpoint import lm_params_from_numpy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402
from repro_torch.optim import compress  # noqa: E402
from repro_torch.sharding import act  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

from torch_lm_cases import configs, reference_params  # noqa: E402

B, S = 2, 16
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
BF16_LEAF_RTOL = 2e-2
LOGIT_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ knobs, search
LAYOUTS = [knobs.BASELINE,
           knobs.LayoutPlan(attn_mode="heads", remat="dots", ce_chunk=16384,
                            grad_compress=True, moe_dispatch="local"),
           knobs.LayoutPlan(attn_mode="none", mla_absorb=True,
                            kv_seq_shard=True, attn_remat=True,
                            attn_scores_bf16=True)]
CUR = {"compute": 1.388, "memory": 11.308, "collective": 8.708,
       "bound": 11.308, "bottleneck": "memory", "mfu_bound": 0.1}


def jlayout(t):
    return jknobs.LayoutPlan(**dataclasses.asdict(t))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_neighbors_and_predictions_match_reference(kind):
    for lay in LAYOUTS:
        jl = jlayout(lay)
        assert lay.name() == jl.name()
        mine, theirs = list(lay.neighbors(kind)), list(jl.neighbors(kind))
        assert [n.name() for n in mine] == [n.name() for n in theirs]
        for nb, jnb in zip(mine, theirs):
            assert search.predict_delta(CUR, nb, lay, kind) == \
                jsearch.predict_delta(CUR, jnb, jl, kind)


def table_record(name: str) -> dict:
    """A deterministic stand-in for a dry-run record of a layout name:
    each knob setting scales the three terms by its own factors."""
    terms = {"compute": 1.0, "memory": 4.0, "collective": 3.0}
    for i, part in enumerate(sorted(name.split(","))):
        h = sum(ord(c) * (j + 1) for j, c in enumerate(part)) % 97
        for k, key in enumerate(terms):
            terms[key] *= 0.8 + ((h * (k + 3) + i) % 41) / 100.0
    bound = max(terms.values())
    return {"roofline": {"t_compute_s": terms["compute"],
                         "t_memory_s": terms["memory"],
                         "t_collective_s": terms["collective"],
                         "t_bound_s": bound,
                         "bottleneck": max(terms, key=terms.get),
                         "mfu_bound": 1.0 / bound}}


@pytest.mark.parametrize("kind,start", [("train", 0), ("train", 1),
                                        ("decode", 2)])
def test_climb_logs_match_reference(kind, start, tmp_path):
    def stub(cls):
        class Stub(cls):
            def evaluate(self, layout):
                return table_record(layout.name())
        return Stub

    lay = LAYOUTS[start]
    a, alogs = stub(search.LayoutReoptimizer)(
        "qwen3-8b", "train_4k", out_dir=tmp_path / "port").climb(
        max_iters=6, kind=kind, start=lay)
    b, blogs = stub(jsearch.LayoutReoptimizer)(
        "qwen3-8b", "train_4k", out_dir=tmp_path / "ref").climb(
        max_iters=6, kind=kind, start=jlayout(lay))
    assert a.name() == b.name()
    assert [dataclasses.asdict(x) for x in alogs] == \
        [dataclasses.asdict(x) for x in blogs]
    assert len(alogs) >= 2
    assert (tmp_path / "port" / "qwen3-8b__train_4k__log.json").read_text() \
        == (tmp_path / "ref" / "qwen3-8b__train_4k__log.json").read_text()


# ------------------------------------------------------------ policy paths
def case(arch):
    jp, tree = reference_params(arch)
    jcfg, tcfg = configs(arch, "float32")
    return jp, lm_params_from_numpy(tree, "cpu"), jcfg, tcfg


def tokens(jcfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(2, jcfg.vocab_size, (b, s)).astype(np.int32)


def both_losses(arch, jpol, tpol, seed=0, b=B, s=S):
    jp, tp, jcfg, tcfg = case(arch)
    toks = tokens(jcfg, seed, b, s)
    with jact.policy(jpol):      # read while the step is traced
        (jl, _), jg = jax.jit(lambda p, b: jax.value_and_grad(
            jlm.loss_fn, has_aux=True)(p, b, jcfg))(
            jp, {"tokens": jnp.asarray(toks)})
    with act.policy(tpol):
        (tl, _), tg = loss_and_grads(tp, {"tokens": torch.from_numpy(toks)},
                                     tcfg)
    return (float(jl), jg), (float(tl), tg), (tp, tcfg, toks)


def check(want, got, loss_rtol=LOSS_RTOL, leaf_rtol=LEAF_RTOL):
    (jl, jg), (tl, tg) = want, got
    assert abs(tl - jl) <= loss_rtol * abs(jl), (tl, jl)
    wl = flatten(jax.tree_util.tree_map(np.asarray, jg))
    gl = flatten(tg)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        top = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= leaf_rtol * top, \
            (path, float(np.abs(a - b).max()), top)


def pols(**kw):
    return jact.ActivationPolicy(**kw), act.ActivationPolicy(**kw)


def test_ce_chunk_policy_matches_reference():
    """ce_chunk = 8 over 2 x 15 targets: 4 chunks, the last ragged."""
    want, got, _ = both_losses("qwen1.5-4b", *pols(ce_chunk=8))
    check(want, got)


@pytest.mark.parametrize("arch", ["qwen3-8b", "dbrx-132b"])
def test_remat_modes_match_reference_and_no_remat(arch):
    jp, tp, jcfg, tcfg = case(arch)
    toks = torch.from_numpy(tokens(jcfg, 1))
    named = flatten(tp)

    def run(remat):
        for _, t in named:
            t.requires_grad_(True)
        loss, _ = lm.loss_fn(tp, {"tokens": toks}, tcfg, remat=remat)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        for _, t in named:
            t.requires_grad_(False)
        return loss.detach(), grads
    plain = run(False)
    for mode in ("full", "dots", "none"):
        with act.policy(act.ActivationPolicy(remat=mode)):
            loss, grads = run(True)
        assert torch.equal(loss, plain[0]), mode
        assert all(torch.equal(a, b) for a, b in zip(grads, plain[1])), mode
    want, got, _ = both_losses(arch, *pols(remat="dots"), seed=1)
    check(want, got)


def test_dots_keeps_matmul_outputs():
    """Under "dots" the backward recomputes no 2-D matmul: the aten.mm
    calls of a forward and backward are fewer than under "full" by the
    forward's own."""
    _, tp, jcfg, tcfg = case("qwen3-8b")
    toks = torch.from_numpy(tokens(jcfg, 2))
    from torch.utils._python_dispatch import TorchDispatchMode

    class MM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                MM.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for mode in ("full", "dots", "none"):
        MM.n = 0
        with act.policy(act.ActivationPolicy(remat=mode)), MM():
            loss_and_grads(tp, {"tokens": toks}, tcfg)
        counts[mode] = MM.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llama4-scout-17b-a16e"])
def test_attn_scores_bf16_matches_reference(arch):
    want, got, (tp, tcfg, toks) = both_losses(
        arch, *pols(attn_scores_bf16=True), seed=3)
    check(want, got, LOSS_RTOL, BF16_LEAF_RTOL)
    _, plain = loss_and_grads(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert any(not torch.equal(a, b) for (_, a), (_, b)
               in zip(flatten(plain), flatten(got[1])))   # the knob acted


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llama4-scout-17b-a16e"])
def test_attn_remat_inert_on_dense_path(arch):
    """At S = 16 both archs take the dense path, where attn_remat changes
    nothing in either package."""
    want, got, _ = both_losses(arch, *pols(attn_remat=True), seed=4)
    check(want, got)


@pytest.mark.parametrize("kind,hdv", [("chunked", 32), ("causal", 16)])
def test_attn_remat_blockwise_matches_reference(kind, hdv):
    """mha on the blockwise path (Sk = 2304) under attn_remat: output and
    gradients against the reference's, and bit for bit the port's own
    without the policy."""
    rng = np.random.default_rng(5)
    Bq, Sk, H, K, hd = 1, 2304, 4, 2, 32
    q = rng.standard_normal((Bq, Sk, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sk, K, hdv)).astype(np.float32)
    w = rng.standard_normal((Bq, Sk, H, hdv)).astype(np.float32)
    pos = np.arange(Sk, dtype=np.int32)
    kw = dict(kind=kind, chunk=1024, scale=0.17)

    def jloss(q, k, v):
        out = jattn.mha(q, k, v, qpos=jnp.asarray(pos), kpos=jnp.asarray(pos),
                        **kw)
        return jnp.sum(out * w), out

    with jact.policy(jact.ActivationPolicy(attn_remat=True)):
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)

    def tgrad():
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        assert not attention.kernel_route(kind, hd, hdv)
        out = attention.mha(*ts, qpos=torch.from_numpy(pos),
                            kpos=torch.from_numpy(pos), **kw)
        g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
        return out.detach(), g

    with act.policy(act.ActivationPolicy(attn_remat=True)):
        tout, tg = tgrad()
    pout, pg = tgrad()
    assert torch.equal(tout, pout)
    assert all(torch.equal(a, b) for a, b in zip(tg, pg))
    for a, b in zip((jout, *jg), (tout, *tg)):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= LEAF_RTOL * np.abs(a).max()


def test_mla_absorbed_decode_matches_reference():
    jp, tp, jcfg, tcfg = case("minicpm3-4b")
    toks = tokens(jcfg, 6, s=12 + 4)
    jpol, tpol = pols(mla_absorb=True)
    with jact.policy(jpol):
        jl, jc = jlm.prefill(jp, jnp.asarray(toks[:, :12]), jcfg, 16)
        jout = []
        for t in range(4):
            jl, jc = jlm.decode_step(jp, jnp.asarray(toks[:, 12 + t:13 + t]),
                                     jc, jcfg, jnp.int32(12 + t))
            jout.append(np.asarray(jl))
    outs = {}
    for name, pol in (("absorbed", tpol), ("expanded", None)):
        with act.policy(pol), torch.inference_mode():
            _, cache = lm.prefill(tp, torch.from_numpy(toks[:, :12]), tcfg,
                                  16)
            outs[name] = [lm.decode_step(
                tp, torch.from_numpy(toks[:, 12 + t:13 + t]), cache, tcfg,
                12 + t)[0].numpy() for t in range(4)]
    for want, got, other in zip(jout, outs["absorbed"], outs["expanded"]):
        top = np.abs(want).max()
        assert np.abs(got - want).max() <= LOGIT_RTOL * top
        assert np.abs(other - got).max() <= LOGIT_RTOL * top
        assert not np.array_equal(other, got)    # another order of sums


def test_moe_local_dispatch_matches_reference():
    """Reduced dbrx, 2 x 16 tokens, top-2: T·K = 64, two assignments a
    block and one capacity slot, so the block-local drops differ from the
    global dispatch's."""
    want, got, (tp, tcfg, toks) = both_losses("dbrx-132b",
                                              *pols(moe_dispatch="local"))
    check(want, got)
    (plain, _), _ = loss_and_grads(tp, {"tokens": torch.from_numpy(toks)},
                                   tcfg)
    assert float(plain) != got[0]


def test_moe_shard_map_matches_reference_on_host_mesh():
    jpol = jact.ActivationPolicy(moe_dispatch="shard_map",
                                 mesh=jmesh.make_host_mesh())
    tpol = act.ActivationPolicy(moe_dispatch="shard_map",
                                mesh=make_host_mesh())
    want, got, _ = both_losses("dbrx-132b", jpol, tpol, seed=2)
    check(want, got)


def np_shard_map(xt, eidx, gate, wg, wu, wd, dp, tp, cf, act_np):
    """The reference's `_dispatch_shard_map` body (repro/models/moe.py:
    176-199), shard by shard in numpy, then the psum over tp."""
    T, D = xt.shape
    E, K = wg.shape[0], eidx.shape[1]
    El, Tl = E // tp, T // dp
    y = np.zeros((T, D), np.float32)
    for d, j in itertools.product(range(dp), range(tp)):
        rows = slice(d * Tl, (d + 1) * Tl)
        xt_l, e_l, g_l = xt[rows], eidx[rows], gate[rows]
        Cl = max(int(cf * Tl * K / E), 1)
        fe = e_l.reshape(-1) - j * El
        mine = (fe >= 0) & (fe < El)
        fe_c = np.clip(fe, 0, El - 1)
        onehot = np.eye(El, dtype=np.int64)[fe_c] * mine[:, None]
        pos = np.cumsum(onehot, axis=0) - 1
        pos_t = pos[np.arange(len(fe_c)), fe_c]
        keep = mine & (pos_t < Cl)
        xk = np.repeat(xt_l, K, axis=0)
        buf = np.zeros((El, Cl, D), np.float32)
        for i in np.nonzero(keep)[0]:
            buf[fe_c[i], pos_t[i]] = xk[i]
        w = slice(j * El, (j + 1) * El)
        h = act_np(np.einsum("ecd,edf->ecf", buf, wg[w])) \
            * np.einsum("ecd,edf->ecf", buf, wu[w])
        yb = np.einsum("ecf,efd->ecd", h, wd[w])
        ytk = yb[fe_c, np.minimum(pos_t, Cl - 1)] * keep[:, None]
        y[rows] += (ytk.reshape(Tl, K, D) * g_l[..., None]).sum(1)
    return y


def test_moe_shard_map_emulation_matches_numpy_body():
    """(dp, tp) = (2, 4) over reduced dbrx with 8 experts, top-2: each
    shard's capacity 2 drops assignments the global dispatch keeps."""
    _, tcfg = configs("dbrx-132b", "float32")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             n_experts=8))
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(prng.prng_key(0), tcfg, device="cpu")
    T, D = 16, tcfg.d_model
    xt = torch.randn((T, D), generator=gen)
    probs = torch.softmax(xt @ p["router"], -1)
    gate, eidx = moe.route(probs, tcfg.moe.top_k)
    pol = act.ActivationPolicy(moe_dispatch="shard_map", dp_size=2,
                               tp_size=4, mesh=make_host_mesh())
    y = moe._dispatch_sharded(xt, eidx, gate, p, tcfg, pol,
                              torch.nn.functional.silu).numpy()
    want = np_shard_map(xt.numpy(), eidx.numpy(), gate.numpy(),
                        *(p[n].numpy() for n in ("moe_wg", "moe_wu",
                                                 "moe_wd")),
                        2, 4, tcfg.moe.capacity_factor,
                        lambda a: a / (1 + np.exp(-a)))
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    full = moe._dispatch_global(
        xt.repeat_interleave(2, 0), eidx.reshape(-1), p, tcfg,
        torch.nn.functional.silu, decode=False)
    glob = (full.reshape(T, 2, D) * gate[..., None]).sum(1).numpy()
    assert not np.allclose(glob, want)       # the shards' drops differ


# ------------------------------------------------------------ compressed psum
def test_compressed_psum_matches_reference():
    import torch.distributed as dist
    try:                                  # jax >= 0.5 top-level export
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    x = (np.random.default_rng(7).standard_normal((64, 48)) * 3
         ).astype(np.float32)
    mesh = jmesh.make_host_mesh()
    want = shard_map(lambda a: jcompress.compressed_psum(a, "model"),
                     mesh=mesh, in_specs=P(), out_specs=P())(jnp.asarray(x))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got = compress.compressed_psum(torch.from_numpy(x))
    finally:
        dist.destroy_process_group()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  compress.dequantize_int8(q, s).numpy())


PSUM_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.compress import compressed_psum
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
x = np.random.default_rng(rank).standard_normal((32, 24)).astype(np.float32)
got = compressed_psum(torch.from_numpy(x * (rank + 1)))
np.save(out, got.numpy())
dist.destroy_process_group()
"""


def test_compressed_psum_across_four_ranks(tmp_path):
    """Four gloo ranks (processes) against the reference's arithmetic in
    numpy: the global max scale, each rank requantized against it, the
    int32 sum, the fp32 result (exact: the same roundings)."""
    import os
    import subprocess
    import sys
    world = 4
    env = dict(os.environ, PYTHONPATH=str(
        __import__("pathlib").Path(__file__).resolve().parents[1] / "src"),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", PSUM_RANK, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / f"out{r}.npy")], env=env)
        for r in range(world)]
    assert all(p.wait(timeout=300) == 0 for p in procs)
    xs = [np.random.default_rng(r).standard_normal((32, 24)).astype(
        np.float32) * np.float32(r + 1) for r in range(world)]
    scale = max(np.float32(np.abs(x).max() + np.float32(1e-12))
                / np.float32(127.0) for x in xs)
    tot = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int8)
              .astype(np.int32) for x in xs)
    want = tot.astype(np.float32) * scale
    for r in range(world):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      want)
