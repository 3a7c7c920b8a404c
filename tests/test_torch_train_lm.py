"""The port's LM training half against the JAX package's, on the CPU.

All ten architectures' reduced configs at compute_dtype="float32", on the
reference's seeded weights carried across with
`checkpoint.lm_params_from_numpy` (tests/torch_lm_cases.py), fed the
same numpy tokens, loss masks, vision memory and audio frames:

* `lm.loss_fn` and every gradient leaf against
  `jax.value_and_grad(repro.models.lm.loss_fn)` (the MoE aux losses,
  whisper's frames through `encode` and llama-vision's memory included);
* three `launch.train.make_train_step` steps against the reference's
  jitted step, on one arch for each code path (THREE_STEP_ARCHS): params,
  AdamW's m and v, `grad_norm` and `lr` each step; and four at reduced
  qwen3-8b on the card's train_lm schedule (lr 3e-4 over 4 steps:
  warmup 1), loss by loss;
* the optimizer pieces: bf16 moments, `compress_grads` with error
  feedback, `cosine_schedule` at every step;
* invariances: the CE chunk (CE_CHUNK monkeypatched to 16) and remat.

Limits. The loss within LOSS_RTOL = 1e-5 of the reference's (measured:
at most 1.5e-7). An fp32 leaf (gradient, parameter, moment) within
LEAF_RTOL = 1e-4 of its largest |value| (measured: gradients at most
2.3e-6). Parameters after the three steps also within STEP_RTOL = 1e-2
of the learning rate summed over the steps: Adam divides each gradient
by its own size, so an element whose gradient is small beside its
leaf's largest, and so known to a larger share of itself, takes a step
known to that share (measured: at most 0.04 of the limit after steps at
lr 1e-2 and 5.5e-3). A wrong update moves an element by a sizeable
share of lr, far outside this. jamba-1.5-large keeps
its parameters, gradients and moments in bf16 (its config): a bf16 leaf
is the rounding of an fp32 value that may lie on the other side of a
rounding boundary, so each element within 2^-7 of its own |value|; and
the errors of its small elements follow its largest ones (a gradient
rounded to 2^-8 of the leaf's largest, squared into v, then rounded
again at each step), so within 2^-6 of the leaf's largest besides
(measured: at most 0.22 of that limit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.optim.compress import compress_grads as jcompress  # noqa: E402
from repro_torch.checkpoint import lm_params_from_numpy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule)
from repro_torch.optim.compress import compress_grads  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402
from torch_lm_cases import configs, reference_params  # noqa: E402

B, S = 2, 12
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
STEP_RTOL = 1e-2
BF16_OWN, BF16_LEAF = 2 ** -7, 2 ** -6
# the three-step parity: one arch a code path (dense attention with
# qk-norm, the scan, enc-dec, vision cross-attention, MLA, MoE, sliding
# window with softcaps and sandwich norms, dense MHA with QKV bias); the
# loss and gradients hold all ten, bf16 moments are jamba's own test
THREE_STEP_ARCHS = ("qwen3-8b", "falcon-mamba-7b", "whisper-tiny",
                    "llama-3.2-vision-90b", "minicpm3-4b", "dbrx-132b",
                    "gemma2-27b", "qwen1.5-4b")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on one host, and torch's default (every core in each)
    oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def check_leaves(want, got, what, slack=0.0):
    """Every leaf of the port's tree `got` against the reference's `want`,
    path for path, at the module docstring's limits plus `slack`."""
    wl = flatten(jax.tree_util.tree_map(np.asarray, want))
    gl = flatten(got)
    assert [p for p, _ in wl] == [p for p, _ in gl], what
    for (path, a), (_, b) in zip(wl, gl):
        bf16 = str(np.asarray(a).dtype) == "bfloat16"
        assert (b.dtype == torch.bfloat16) == bf16, f"{what} {path} dtype"
        a, b = as_np(a), as_np(b)
        assert a.shape == b.shape, f"{what} {path}"
        top = max(float(np.abs(a).max()), 1e-30)
        limit = slack + (BF16_OWN * np.abs(a) + BF16_LEAF * top if bf16
                         else LEAF_RTOL * top)
        assert np.all(np.abs(a - b) <= limit), \
            f"{what} {path}: {float(np.abs(a - b).max())} of {top}"


def batches(jcfg, tcfg, seed, n=1, mask=True):
    """n batches of numpy tokens (B, S), loss masks, vision memory and
    audio frames, as the reference's and the port's tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(2, jcfg.vocab_size, (B, S)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens":
                                                 torch.from_numpy(toks)}
        if mask:
            m = (rng.random((B, S)) > 0.2).astype(np.float32)
            jb["loss_mask"], tb["loss_mask"] = jnp.asarray(m), \
                torch.from_numpy(m)
        if jcfg.family == "vlm":
            m = (0.01 * rng.standard_normal(
                (B, jcfg.vision_tokens, jcfg.d_model))).astype(np.float32)
            jb["memory"] = jnp.asarray(m, jcfg.cdtype)
            tb["memory"] = torch.from_numpy(m).to(tcfg.cdtype)
        if jcfg.encoder is not None:
            f = (0.01 * rng.standard_normal(
                (B, jcfg.encoder.n_frames, jcfg.d_model))).astype(np.float32)
            jb["frames"], tb["frames"] = jnp.asarray(f), torch.from_numpy(f)
        out.append((jb, tb))
    return out


def case(arch):
    jp, tree = reference_params(arch)
    jcfg, tcfg = configs(arch, "float32")
    return jp, lm_params_from_numpy(tree, "cpu"), jcfg, tcfg


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_loss_and_grads_match_reference(arch):
    """loss_fn's loss, ce and aux and every gradient leaf against
    jax.value_and_grad(lm.loss_fn), with a loss mask."""
    jp, tp, jcfg, tcfg = case(arch)
    (jb, tb), = batches(jcfg, tcfg, seed=0)
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(jp, jb,
                                                                 jcfg)
    (tl, tm), tg = loss_and_grads(tp, tb, tcfg)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= \
        LOSS_RTOL * abs(float(jm["ce"]))
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= \
        LOSS_RTOL * max(abs(float(jm["aux"])), 1e-6)
    if jcfg.moe is not None:
        assert float(jm["aux"]) > 0
    check_leaves(jg, tg, f"{arch} grad")
    assert all(not t.requires_grad for _, t in flatten(tp))


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("arch", THREE_STEP_ARCHS)
def test_three_train_steps_match_reference(arch):
    """launch.train.make_train_step (no compression) three times against
    the reference's jitted step on the same batches, lr 1e-2 and a
    3-step cosine (warmup 1: lr 0, then 1e-2, then 5.5e-3): loss,
    grad_norm and lr each step, then params, m, v (in the config's
    moment dtype) and the step count."""
    jp, tp, jcfg, tcfg = case(arch)
    jstep = jax.jit(jtrain.make_train_step(jcfg, JAdamWConfig(lr=1e-2), 3))
    tstep = ttrain.make_train_step(tcfg, AdamWConfig(lr=1e-2), 3)
    js = jadamw_init(jp, jnp.dtype(jcfg.opt_moment_dtype))
    ts = adamw_init(tp, getattr(torch, tcfg.opt_moment_dtype))
    lr_sum = 0.0
    for jb, tb in batches(jcfg, tcfg, seed=1, n=3, mask=False):
        jp, js, _, jm = jstep(jp, js, 0, jb)
        tp, ts, _, tm = tstep(tp, ts, 0, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                LOSS_RTOL * abs(float(jm[k])), k
        assert float(tm["lr"]) == float(jm["lr"])
        lr_sum += float(jm["lr"])
    check_leaves(jp, tp, f"{arch} params", slack=STEP_RTOL * lr_sum)
    check_leaves(js["m"], ts["m"], f"{arch} m")
    check_leaves(js["v"], ts["v"], f"{arch} v")
    assert int(ts["step"]) == int(js["step"]) == 3


def test_four_steps_at_the_card_cells_schedule_match_reference():
    """The schedule of the card's train_lm cell at reduced qwen3-8b:
    make_train_step(cfg, AdamWConfig(lr=3e-4), 4), warmup 1 (lr 0, then
    the full 3e-4, then the cosine), four steps against the reference's
    jitted step on the same batches: loss, grad_norm and lr each step,
    then params, m and v."""
    jp, tp, jcfg, tcfg = case("qwen3-8b")
    jstep = jax.jit(jtrain.make_train_step(jcfg, JAdamWConfig(lr=3e-4), 4))
    tstep = ttrain.make_train_step(tcfg, AdamWConfig(lr=3e-4), 4)
    js = jadamw_init(jp, jnp.dtype(jcfg.opt_moment_dtype))
    ts = adamw_init(tp, getattr(torch, tcfg.opt_moment_dtype))
    lrs = []
    for jb, tb in batches(jcfg, tcfg, seed=2, n=4, mask=False):
        jp, js, _, jm = jstep(jp, js, 0, jb)
        tp, ts, _, tm = tstep(tp, ts, 0, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                LOSS_RTOL * abs(float(jm[k])), k
        assert float(tm["lr"]) == float(jm["lr"])
        lrs.append(float(jm["lr"]))
    assert lrs[0] == 0.0 and lrs[1] == np.float32(3e-4)
    check_leaves(jp, tp, "qwen3-8b params", slack=STEP_RTOL * sum(lrs))
    check_leaves(js["m"], ts["m"], "qwen3-8b m")
    check_leaves(js["v"], ts["v"], "qwen3-8b v")


# ------------------------------------------------------------ optimizer
def test_bf16_moments_match_reference():
    """adamw_init(moment_dtype=bf16) and three updates on reduced jamba's
    own bf16 parameters, fed the same random fp32 gradients: m and v are
    bf16, params and moments within the bf16 limit."""
    jp, tp, jcfg, _ = case("jamba-1.5-large-398b")
    assert jcfg.opt_moment_dtype == "bfloat16"
    js = jadamw_init(jp, jnp.bfloat16)
    ts = adamw_init(tp, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in flatten(ts["m"]))
    rng = np.random.default_rng(3)
    cfg = dict(lr=1e-2, grad_clip=5.0)
    jupdate = jax.jit(jadamw_update, static_argnums=3)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        jp, js, jm = jupdate(jp, g, js, JAdamWConfig(**cfg))
        tp, ts, tm = adamw_update(tp, tree_map(torch.from_numpy, g), ts,
                                  AdamWConfig(**cfg))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            LOSS_RTOL * float(jm["grad_norm"])
    for what in ("m", "v"):
        check_leaves(js[what], ts[what], f"bf16 {what}")
    check_leaves(jp, tp, "bf16 params")


def test_adamw_slices_keep_every_element(monkeypatch):
    """A leaf updated in slices of CHUNK elements gives, bit for bit, what
    it gives updated whole."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(4)

    def tree():
        return {"stack": torch.from_numpy(rng.standard_normal(
            (5, 7, 3)).astype(np.float32)),
            "s": torch.tensor(0.5), "b": torch.ones(11)}
    p, g = tree(), tree()
    q = tree_map(torch.clone, p)
    sp, sq = adamw_init(p), adamw_init(q)
    adamw_update(p, g, sp, AdamWConfig())
    monkeypatch.setattr(adamw, "CHUNK", 8)
    chunk = adamw._chunk(q["stack"].device)
    assert chunk == 8 and adamw._chunk(torch.device("meta")) == 8
    assert len(adamw._slices(q["stack"], chunk)) == 5
    assert len(adamw._slices(q["b"], chunk)) == 2
    adamw_update(q, g, sq, AdamWConfig())
    for (path, a), (_, b) in zip(flatten([p, sp]), flatten([q, sq])):
        assert torch.equal(a, b), path


def test_compress_grads_match_reference():
    """compress_grads with error feedback, four steps on the same
    gradients: dequantized gradients and error states leaf for leaf
    (int8 codes equal: |x / scale| rounds half to even on both sides)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (64, 16), "b": (16,), "deep": {"x": (3, 5, 7)}}

    def draw():
        return tree_map(lambda s: (rng.standard_normal(s) * 3).astype(
            np.float32), shapes)
    jerr = terr = None
    for _ in range(4):
        g = draw()
        jdq, jerr = jcompress(jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tdq, terr = compress_grads(tree_map(torch.from_numpy, g), terr)
        for want, got in ((jdq, tdq), (jerr, terr)):
            wl = flatten(jax.tree_util.tree_map(np.asarray, want))
            for (path, a), (_, b) in zip(wl, flatten(got)):
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                           atol=1e-6, err_msg=path)


@pytest.mark.parametrize("warmup,total", [(0, 10), (20, 1000), (200, 10000)])
def test_cosine_schedule_matches_reference(warmup, total):
    """cosine_schedule at every step from 0 past `total`, from a Python
    int and from an int32 tensor: an fp32 scalar within 2^-24 of the
    reference's. XLA's and torch's fp32 cos may differ in their last bit,
    up to 2^-24 near |cos| = 1, which 1 + cos and the product by 0.45
    carry into the result (measured: 2.98e-8 at step 8 of 10)."""
    steps = range(0, total + 3, max(1, total // 400))
    for s in steps:
        want = float(jcosine(jnp.asarray(s, jnp.int32), warmup=warmup,
                             total=total))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = cosine_schedule(step, warmup=warmup, total=total)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 2 ** -24, s


# ------------------------------------------------------------ invariances
def test_ce_chunk_invariance(monkeypatch):
    """The loss and its gradients with CE_CHUNK = 16 (ragged last chunk:
    2 x 31 tokens) against one chunk, and the reference's own loss."""
    jp, tp, jcfg, tcfg = case("qwen1.5-4b")
    rng = np.random.default_rng(6)
    toks = rng.integers(2, jcfg.vocab_size, (2, 32)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(toks)}
    (l1, _), g1 = loss_and_grads(tp, tb, tcfg)
    monkeypatch.setattr(lm, "CE_CHUNK", 16)
    (l2, _), g2 = loss_and_grads(tp, tb, tcfg)
    jl, _ = jlm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    assert abs(float(l1) - float(l2)) <= LOSS_RTOL * abs(float(l1))
    assert abs(float(l2) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for (path, a), (_, b) in zip(flatten(g1), flatten(g2)):
        assert float((a - b).abs().max()) <= \
            LEAF_RTOL * max(float(a.abs().max()), 1e-30), path


@pytest.mark.parametrize("arch", ["gemma2-27b", "falcon-mamba-7b",
                                  "dbrx-132b"])
def test_remat_invariance(arch):
    """remat=True (a checkpoint a superblock) against remat=False: the
    same loss and gradients (the same ops run again)."""
    _, tp, jcfg, tcfg = case(arch)
    (_, tb), = batches(jcfg, tcfg, seed=7)
    out = {}
    for remat in (True, False):
        named = flatten(tp)
        for _, t in named:
            t.requires_grad_(True)
        loss, _ = lm.loss_fn(tp, tb, tcfg, remat=remat)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        for _, t in named:
            t.requires_grad_(False)
        out[remat] = (loss.detach(), grads)
    (l1, g1), (l2, g2) = out[True], out[False]
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_forward_remat_changes_nothing_without_grads():
    """Under inference the remat flag is inert: forward's logits equal."""
    _, tp, jcfg, tcfg = case("qwen3-8b")
    (_, tb), = batches(jcfg, tcfg, seed=8, mask=False)
    with torch.inference_mode():
        a = lm.forward(tp, tb["tokens"], tcfg, remat=True)[0]
        b = lm.forward(tp, tb["tokens"], tcfg, remat=False)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_smoke_train_step_finite(arch):
    """The reference's test_smoke_forward_and_train_step on the port: the
    reduced arch at its own dtypes, from the port's seeded weights: a
    plausible finite loss, a finite non-zero gradient norm and finite
    parameters after one step of launch.steps.make_train_step."""
    from repro_torch.configs import registry
    from repro_torch.launch.steps import make_train_step
    cfg = registry.reduced(registry.get_config(arch))
    params = lm.init_params(prng.prng_key(0), cfg, device="cpu")
    (_, tb), = batches(*configs(arch, None), seed=9, mask=False)
    step = make_train_step(cfg, AdamWConfig(), total_steps=10)
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    params, opt, m = step(params, opt, tb)
    assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert 3.0 < float(m["loss"]) < 12.0
    assert 0 < float(m["grad_norm"]) < float("inf")
    assert all(torch.isfinite(t.float()).all() for _, t in flatten(params))
    assert int(opt["step"]) == 1


# ------------------------------------------------ the kernels' Functions
def test_kernel_functions_backward_under_remat(monkeypatch):
    """FlashAttention and MambaScan, their kernel launch replaced by the
    plain version (the kernels run on the card only), inside a
    non-reentrant checkpoint as remat runs them: the gradients of every
    input equal the same Functions' without the checkpoint (under remat
    the backward may read its saved tensors once), and plain autograd's
    through the plain forward within 1e-5 of each gradient's largest
    |value| (the Functions' backward is the plain backward,
    `ref.flash_attention_bwd_ref` / `ref.mamba_scan_bwd_ref`, which sums
    in another order than autograd)."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    monkeypatch.setattr(fa, "_forward",
                        lambda q, k, v, **kw: ref.flash_attention_ref(
                            q, k, v, **kw))
    monkeypatch.setattr(ms, "_forward", ms._plain)
    rng = np.random.default_rng(10)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).requires_grad_(True)
    q, k, v = t(8, 24, 32), t(4, 24, 32), t(4, 24, 32)
    kw = dict(causal=True, window=8, softcap=20.0, scale=None)
    x, dt, Bs, Cs = t(2, 16, 12), t(2, 16, 12, scale=0.1), t(2, 16, 4), \
        t(2, 16, 4)
    A, D, h0 = t(12, 4), t(12), t(2, 12, 4)

    def attn(q, k, v):
        return fa.FlashAttention.apply(q, k, v, *kw.values()).square().sum()

    def scan(*a):
        y, h = ms.MambaScan.apply(*a)
        return (y * y.detach()).sum() + h.sum()
    sargs = (x, dt, A, Bs, Cs, D, h0)
    for fn, args, plain in (
            (attn, (q, k, v), lambda: ref.flash_attention_ref(
                q, k, v, **kw).square().sum()),
            (scan, sargs, lambda: scan_plain(*sargs))):
        got = torch.autograd.grad(checkpoint(fn, *args, use_reentrant=False),
                                  args)
        alone = torch.autograd.grad(fn(*args), args)
        want = torch.autograd.grad(plain(), args)
        for g, a, w in zip(got, alone, want):
            torch.testing.assert_close(g, a, rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(
                g, w, rtol=0.0, atol=1e-5 * float(w.abs().max()))


def scan_plain(x, dt, A, Bs, Cs, D, h0):
    from repro_torch.kernels import ref
    y, h = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
    y = y + x * D
    return (y * y.detach()).sum() + h.sum()
