"""The plain backwards of the port's attention and scan kernels against
`jax.vjp` of the reference's oracles, on the CPU.

The reference's Pallas kernels have no VJP: its LMs train through jnp
autodiff of `repro.kernels.ref.flash_attention_ref` and `mamba_scan_ref`.
So `ref.flash_attention_bwd_ref` and `ref.mamba_scan_bwd_ref` (what the
autograd Functions run for CPU tensors, and what the backward kernels are
held to on the card) are held here to `jax.vjp` of those oracles, with
k/v repeated over each GQA group inside the differentiated function so
that the vjp sums dk and dv over the group. Inputs and cotangents come
from a numpy seed. fp32, each gradient within 1e-5 of its largest
magnitude (the same function; the sums run in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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


def _jax_attention_vjp(q, k, v, g, G, kw):
    def f(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, G, axis=0),
                                        jnp.repeat(v, G, axis=0), **kw)
    out, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), pull(jnp.asarray(g))


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,causal,window,cap", ATTN_CASES)
def test_flash_attention_bwd_ref_matches_jax_vjp(BH, BKV, Sq, Sk, hd,
                                                 causal, window, cap):
    q, k, v, g = _attn_inputs(BH, BKV, Sq, Sk, hd, seed=BH + Sq + Sk)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, want = _jax_attention_vjp(q, k, v, g, BH // BKV, kw)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(out), _t(g),
                                      **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        _close(a, b, name)
    if Sq > Sk and causal:                 # rows with no allowed key
        dead = Sq - Sk
        assert not got[0][:, :dead].any()
        assert np.all(np.asarray(want[0])[:, :dead] == 0)


def test_flash_attention_bwd_ref_keeps_bf16():
    q, k, v, g = _attn_inputs(4, 2, 20, 20, 32, seed=3)
    bf = [_t(a).bfloat16() for a in (q, k, v, g)]
    out = ref.flash_attention_ref(*bf[:3])
    dq, dk, dv = ref.flash_attention_bwd_ref(*bf[:3], out, bf[3])
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dq.shape == (4, 20, 32) and dk.shape == dv.shape == (2, 20, 32)


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,causal,window,cap",
                         [ATTN_CASES[0], ATTN_CASES[4], ATTN_CASES[7]])
def test_flash_attention_function_reaches_the_plain_backward(
        BH, BKV, Sq, Sk, hd, causal, window, cap, monkeypatch):
    """`flash_attention` with gradients on CPU tensors: the backward is
    one call of the plain backward (no autograd through the plain
    forward), and its gradients equal jax.vjp's."""
    q, k, v, g = _attn_inputs(BH, BKV, Sq, Sk, hd, seed=7)
    kw = dict(causal=causal, window=window, softcap=cap)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.flash_attention_ref, ref.flash_attention_bwd_ref

    def count(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(ref, "flash_attention_ref", count("fwd", fwd))
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", count("bwd", bwd))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), _t(g))
    assert calls == {"fwd": 1, "bwd": 1}
    assert fa.launches == 0 and fa.bwd_launches == 0
    jout, want = _jax_attention_vjp(q, k, v, g, BH // BKV, kw)
    _close(out, jout, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)


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


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("with_h0,with_D", [(False, False), (True, True),
                                            (False, True)])
@pytest.mark.parametrize("cot", ["both", "y", "h"])
def test_mamba_scan_bwd_ref_matches_jax_vjp(N, with_h0, with_D, cot):
    x, dt, A, Bs, Cs, D, h0, gy, gh = _scan_inputs(2, 33, 12, N,
                                                   seed=N + 3 * with_h0)
    D = D if with_D else None
    h0 = h0 if with_h0 else None
    gy = gy if cot in ("both", "y") else None
    gh = gh if cot in ("both", "h") else None
    want = _jax_scan_vjp(x, dt, A, Bs, Cs, D, h0, gy, gh)
    got = ref.mamba_scan_bwd_ref(
        *(None if a is None else _t(a)
          for a in (x, dt, A, Bs, Cs, D, h0, gy, gh)))
    for name, a, b in zip(SCAN_NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        _close(a, b, name)


def test_mamba_scan_function_reaches_the_plain_backward(monkeypatch):
    """`mamba_scan` with gradients on CPU tensors (D and h0 given, a
    cotangent on y and h_last): the backward is one call of the plain
    backward, and every gradient equals jax.vjp's."""
    x, dt, A, Bs, Cs, D, h0, gy, gh = _scan_inputs(2, 33, 12, 16, seed=5)
    calls = []
    bwd = ref.mamba_scan_bwd_ref

    def count(*a):
        calls.append(1)
        return bwd(*a)
    monkeypatch.setattr(ref, "mamba_scan_bwd_ref", count)
    ins = [_t(a).requires_grad_(True) for a in (x, dt, A, Bs, Cs, D, h0)]
    y, h = ms.mamba_scan(*ins[:5], D=ins[5], h0=ins[6])
    assert type(y.grad_fn).__name__ == "MambaScanBackward"
    got = torch.autograd.grad((y, h), ins, (_t(gy), _t(gh)))
    assert len(calls) == 1
    assert ms.launches == 0 and ms.bwd_launches == 0
    want = _jax_scan_vjp(x, dt, A, Bs, Cs, D, h0, gy, gh)
    for name, a, b in zip(SCAN_NAMES, got, want):
        _close(a, b, name)


def test_mamba_scan_function_grads_where_asked():
    """Only the inputs that need a gradient get one; y alone as the
    output used (h_last's cotangent None) still reaches every input."""
    x, dt, A, Bs, Cs, D, h0, gy, _ = _scan_inputs(1, 9, 8, 4, seed=2)
    xt, dtt = _t(x).requires_grad_(True), _t(dt).requires_grad_(True)
    y, _ = ms.mamba_scan(xt, dtt, _t(A), _t(Bs), _t(Cs), D=_t(D))
    gx, gdt = torch.autograd.grad(y, (xt, dtt), _t(gy))
    want = _jax_scan_vjp(x, dt, A, Bs, Cs, D, None, gy, None)
    _close(gx, want[0], "dx")
    _close(gdt, want[1], "ddt")
