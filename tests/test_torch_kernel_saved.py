"""What the forward kernels save for their backwards, on the CPU: each
attention row's logsumexp and the scan's chunk states, by their plain
versions, against the reference; and the plain backwards started from
them against `jax.vjp` of the reference's oracles.

The bf16 attention forward kernels write each row's logsumexp, which the
backward kernels read in place of a pass of their own; the scan forward
kernel writes the state before every `mamba_scan.CHUNK`-th step, from
which the backward recomputes each chunk. `ref.flash_attention_ref(...,
return_lse=True)` and `ref.mamba_scan_ref(..., chunk=...)` are their plain
versions (what the autograd Functions save on the CPU, and what the
kernels are held to on the card); `ref.flash_attention_bwd_ref(...,
lse=...)` and `ref.mamba_scan_bwd_ref(..., states)` the plain backwards
started from them. Inputs from a numpy seed; fp32; each within 1e-5 of
its largest magnitude (the same function, sums in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref, work  # noqa: E402

RTOL = 1e-5


def _close(got, want, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, (name, err, scale)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------- attention
ATTN_CASES = [  # BH, BKV, Sq, Sk, hd, causal, window, softcap
    (8, 2, 40, 40, 32, True, 0, 0.0),      # GQA 4:1, causal
    (4, 4, 24, 30, 32, False, 0, 0.0),     # bidirectional, Sq < Sk
    (4, 2, 48, 48, 16, True, 8, 0.0),      # sliding window
    (4, 2, 33, 33, 16, False, 6, 0.0),     # window without causal
    (4, 4, 32, 32, 32, True, 0, 5.0),      # softcap (scores reach it)
    (4, 2, 12, 40, 32, True, 0, 0.0),      # right-aligned Sq < Sk
    (4, 2, 40, 12, 32, True, 0, 0.0),      # Sq > Sk: fully masked rows
    (6, 3, 37, 53, 32, True, 5, 30.0),     # ragged, window and softcap
]


def _attn_inputs(BH, BKV, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Sq, hd)).astype(np.float32) * 2.0
    k = rng.standard_normal((BKV, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((BKV, Sk, hd)).astype(np.float32)
    g = rng.standard_normal((BH, Sq, hd)).astype(np.float32)
    return q, k, v, g


def _jax_masked_scores(q, k, G, causal, window, softcap):
    """The scores `repro.kernels.ref.flash_attention_ref` takes the softmax
    of, built as it builds them (-inf where masked), k repeated over each
    GQA group."""
    q, k = jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=0)
    s = jnp.einsum("bqd,bkd->bqk", q, k) * q.shape[-1] ** -0.5
    if softcap > 0:
        s = softcap * jnp.tanh(s / softcap)
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = jnp.arange(Sq)[:, None] + (Sk - Sq)
    kpos = jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return jnp.where(mask[None], s, -jnp.inf)


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,causal,window,cap", ATTN_CASES)
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(
        BH, BKV, Sq, Sk, hd, causal, window, cap):
    """Each row's logsumexp as the forward saves it equals
    jax.nn.logsumexp of the reference's masked scores; a row with no
    allowed key (jax: -inf) saves +inf, so that exp(s - lse) is 0 on every
    key; the output is the plain version's without the flag."""
    q, k, v, _ = _attn_inputs(BH, BKV, Sq, Sk, hd, seed=BH + Sq)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw,
                                       return_lse=True)
    want = np.asarray(jax.nn.logsumexp(
        _jax_masked_scores(q, k, BH // BKV, causal, window, cap), axis=-1))
    assert lse.shape == (BH, Sq) and lse.dtype == torch.float32
    dead = np.isinf(want)
    assert np.array_equal(torch.isinf(lse).numpy(), dead)
    assert (want[dead] < 0).all() and (lse.numpy()[dead] > 0).all()
    assert dead.any() == (Sq > Sk and causal)
    _close(lse[torch.from_numpy(~dead)], want[~dead], "lse")
    assert torch.equal(out, ref.flash_attention_ref(_t(q), _t(k), _t(v),
                                                    **kw))


def _jax_attention_vjp(q, k, v, g, G, kw):
    def f(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, G, axis=0),
                                        jnp.repeat(v, G, axis=0), **kw)
    out, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), pull(jnp.asarray(g))


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,causal,window,cap", ATTN_CASES)
def test_plain_bwd_from_the_saved_lse_matches_jax_vjp(
        BH, BKV, Sq, Sk, hd, causal, window, cap):
    """The plain backward started from the saved logsumexp (the kernels'
    algorithm: no pass of its own over the keys) equals jax.vjp of the
    reference's oracle; rows with no allowed key pass back exact zeros."""
    q, k, v, g = _attn_inputs(BH, BKV, Sq, Sk, hd, seed=3 * BH + Sk)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw,
                                       return_lse=True)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, _t(g), **kw,
                                      lse=lse)
    jout, want = _jax_attention_vjp(q, k, v, g, BH // BKV, kw)
    _close(out, jout, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)
    if Sq > Sk and causal:
        assert not got[0][:, :Sq - Sk].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_saves_the_lse_on_the_cpu(dtype, monkeypatch):
    """`flash_attention` with gradients on CPU tensors saves the plain
    logsumexp with its inputs and output, and its backward is one call of
    the plain backward that reads it."""
    q, k, v, g = _attn_inputs(6, 3, 37, 53, 32, seed=11)
    kw = dict(causal=True, window=5, softcap=30.0)
    seen = []
    bwd = ref.flash_attention_bwd_ref

    def spy(*a, **k):
        seen.append(k["lse"])
        return bwd(*a, **k)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", spy)
    qt, kt, vt = (_t(a).to(dtype).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, **kw)
    saved = out.grad_fn.saved_tensors
    _, want = ref.flash_attention_ref(qt.detach(), kt.detach(), vt.detach(),
                                      **kw, return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[4], want)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(g).to(dtype))
    assert len(seen) == 1 and torch.equal(seen[0], want)
    assert all(t.dtype == dtype for t in grads)
    assert fa.launches == 0 and fa.bwd_launches == 0


# ---------------------------------------------------------- the scan
def _scan_inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, di))) * 0.1 + 0.01).astype(
        np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1)) \
        * rng.uniform(0.5, 1.5, (di, 1)).astype(np.float32)
    Bs = rng.standard_normal((B, S, N)).astype(np.float32)
    Cs = rng.standard_normal((B, S, N)).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    gy = rng.standard_normal((B, S, di)).astype(np.float32)
    gh = rng.standard_normal((B, di, N)).astype(np.float32)
    return x, dt, A, Bs, Cs, D, h0, gy, gh


@pytest.mark.parametrize("S", [16, 33, 48])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_chunk_states_are_the_reference_prefix_states(S, N, with_h0):
    """The state kept before step CHUNK·c is the reference oracle's h after
    the first CHUNK·c steps (the oracle run on that prefix; h0, or zeros,
    at c = 0); y and h_last are the plain version's without the flag."""
    x, dt, A, Bs, Cs, _, h0, _, _ = _scan_inputs(2, S, 12, N, seed=S + N)
    h0 = h0 if with_h0 else None
    args = [_t(a) for a in (x, dt, A, Bs, Cs)]
    y, h, states = ref.mamba_scan_ref(*args, None if h0 is None else _t(h0),
                                      chunk=ms.CHUNK)
    chunks = -(-S // ms.CHUNK)
    assert states.shape == (2, chunks, 12, N)
    start = np.zeros((2, 12, N), np.float32) if h0 is None else h0
    _close(states[:, 0], start, "chunk 0")
    for c in range(1, chunks):
        t = c * ms.CHUNK
        _, want = jref.mamba_scan_ref(x[:, :t], dt[:, :t], A, Bs[:, :t],
                                      Cs[:, :t], None if h0 is None
                                      else jnp.asarray(h0))
        _close(states[:, c], want, f"chunk {c}")
    y0, h_last = ref.mamba_scan_ref(*args, None if h0 is None else _t(h0))
    assert torch.equal(y, y0) and torch.equal(h, h_last)


def _jax_scan_vjp(x, dt, A, Bs, Cs, D, h0, gy, gh):
    """jax.vjp of (y (+ x·D), h_last) of the reference's oracle; a None
    cotangent is a zero one."""
    def f(x, dt, A, Bs, Cs, D, h0):
        y, h = jref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
        return (y if D is None else y + x * D), h
    args = [None if a is None else jnp.asarray(a)
            for a in (x, dt, A, Bs, Cs, D, h0)]
    live = [i for i, a in enumerate(args) if a is not None]

    def g(*xs):
        full = list(args)
        for i, a in zip(live, xs):
            full[i] = a
        return f(*full)
    (y, h), pull = jax.vjp(g, *(args[i] for i in live))
    cot = (jnp.zeros_like(y) if gy is None else jnp.asarray(gy),
           jnp.zeros_like(h) if gh is None else jnp.asarray(gh))
    grads = dict(zip(live, pull(cot)))
    return [grads.get(i) for i in range(7)]


SCAN_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


@pytest.mark.parametrize("S", [33, 48])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("with_h0,with_D", [(False, False), (True, True)])
@pytest.mark.parametrize("cot", ["both", "y"])
def test_plain_bwd_from_the_chunk_states_matches_jax_vjp(S, N, with_h0,
                                                         with_D, cot):
    """The plain backward started from the kept chunk states (each chunk
    recomputed from its own state, as the kernel does) equals jax.vjp of
    the reference's oracle."""
    x, dt, A, Bs, Cs, D, h0, gy, gh = _scan_inputs(2, S, 12, N,
                                                   seed=2 * S + N)
    D = D if with_D else None
    h0 = h0 if with_h0 else None
    gh = gh if cot == "both" else None
    t = [None if a is None else _t(a) for a in (x, dt, A, Bs, Cs, D, h0, gy,
                                                 gh)]
    _, _, states = ref.mamba_scan_ref(*t[:5], t[6], chunk=ms.CHUNK)
    got = ref.mamba_scan_bwd_ref(*t, states, ms.CHUNK)
    want = _jax_scan_vjp(x, dt, A, Bs, Cs, D, h0, gy, gh)
    for name, a, b in zip(SCAN_NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        _close(a, b, name)


def test_scan_function_saves_the_chunk_states_on_the_cpu(monkeypatch):
    """`mamba_scan` with gradients on CPU tensors saves the plain chunk
    states with its inputs, and its backward is one call of the plain
    backward started from them."""
    x, dt, A, Bs, Cs, D, h0, gy, gh = _scan_inputs(2, 40, 12, 16, seed=5)
    seen = []
    bwd = ref.mamba_scan_bwd_ref

    def spy(*a):
        seen.append(a[9:])
        return bwd(*a)
    monkeypatch.setattr(ref, "mamba_scan_bwd_ref", spy)
    ins = [_t(a).requires_grad_(True) for a in (x, dt, A, Bs, Cs, D, h0)]
    y, h = ms.mamba_scan(*ins[:5], D=ins[5], h0=ins[6])
    saved = y.grad_fn.saved_tensors
    _, _, want = ref.mamba_scan_ref(*(t.detach() for t in ins[:5]),
                                    ins[6].detach(), chunk=ms.CHUNK)
    assert len(saved) == 8 and torch.equal(saved[7], want)
    got = torch.autograd.grad((y, h), ins, (_t(gy), _t(gh)))
    assert len(seen) == 1 and torch.equal(seen[0][0], want)
    assert seen[0][1] == ms.CHUNK
    assert ms.launches == 0 and ms.bwd_launches == 0
    for name, a, b in zip(SCAN_NAMES, got,
                          _jax_scan_vjp(x, dt, A, Bs, Cs, D, h0, gy, gh)):
        _close(a, b, name)


# ------------------------------------------------ fakes and counted work
def test_meta_fakes_save_what_the_card_saves():
    """On `meta` (a dry run) the forwards return empty fakes of what the
    kernels save: bf16 attention a (BH, Sq) fp32 logsumexp (fp32: none,
    its backward makes its own), the scan its (B, ceil(S / CHUNK), di, N)
    states; no kernel is launched."""
    meta = torch.device("meta")
    for dtype, want in ((torch.bfloat16, (8, 40)), (torch.float32, None)):
        q = torch.empty((8, 40, 32), dtype=dtype, device=meta)
        k = torch.empty((2, 50, 32), dtype=dtype, device=meta)
        out, lse = fa._forward(q, k, k, causal=True, window=0, softcap=0.0,
                               scale=None, return_lse=True)
        assert out.shape == q.shape
        assert (lse is None) if want is None else (
            lse.shape == want and lse.dtype == torch.float32
            and lse.device == meta)
    x = torch.empty((2, 33, 64), device=meta)
    A = torch.empty((64, 16), device=meta)
    Bs = torch.empty((2, 33, 16), device=meta)
    y, h, states = ms._forward(x, x, A, Bs, Bs, None, None,
                               with_states=True)
    assert states.shape == (2, 3, 64, 16) and states.device == meta
    assert fa.launches == 0 and ms.launches == 0


@pytest.mark.parametrize("B,S,di,N,BH,BKV,hd", [(2, 512, 8192, 16, 128, 32,
                                                 128), (1, 33, 96, 4, 8, 8,
                                                        64)])
def test_work_counts_the_saved_outputs(B, S, di, N, BH, BKV, hd):
    """The counted work adds the saved outputs' bytes where a kernel
    writes or reads them (fp32, once each) and nothing else: the FLOPs,
    and the function's own bytes (the kernels' bound), stay."""
    kw = dict(causal=True, window=0, itemsize=2)
    for fn in (work.attention_work, work.attention_bwd_work):
        base = fn(BH, BKV, S, S, hd, **kw)
        more = fn(BH, BKV, S, S, hd, **kw, lse=True)
        assert more[1] == base[1] and more[0] - base[0] == 4 * BH * S
    states = 4 * B * -(-S // ms.CHUNK) * di * N
    for fn in (work.scan_work, work.scan_bwd_work):
        base = fn(B, S, di, N)
        more = fn(B, S, di, N, states=ms.CHUNK)
        assert more[1] == base[1] and more[0] - base[0] == states
