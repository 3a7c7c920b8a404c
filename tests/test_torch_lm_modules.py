"""The port's model modules against the JAX package's, one at a time, on
the CPU: norms and RoPE, `attention.mha` on the reference's dense path
(Sk <= 2048) and its blockwise path (Sk > 2048) for every mask kind,
`mamba.selective_scan` (y and h_last, with and without h0) and
`moe.apply_moe` / `apply_mlp` with the reference's single-device dispatch.
Inputs and weights are made with numpy from a seed and given to both.

Limits: fp32 throughout, 1e-5 (absolute and relative) but for the scan,
which the port runs sequentially in time and the reference as a chunked
associative scan (another order of the same fp32 sums): 1e-4, the limit
tests/test_kernels.py holds the Pallas scan to. One bf16 attention case:
2e-2, the bf16 limit of tests/test_torch_ops.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.models import attention, common, mamba, moe  # noqa: E402

import jax  # noqa: E402


def _close(port, want, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _pair(a, dtype="float32"):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch,
                                                                 dtype)))


# ------------------------------------------------------------ norms, rope
@pytest.mark.parametrize("kind,unit", [("rmsnorm", False), ("rmsnorm", True),
                                       ("layernorm", False)])
def test_norm_matches_reference(kind, unit):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = jcommon.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind, unit_offset=unit)
    got = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind, unit_offset=unit)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("theta,positions", [
    (10_000.0, np.arange(16)), (1_000_000.0, np.arange(150, 154)),
    (500_000.0, np.array([4095]))])
def test_rope_matches_reference(theta, positions):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, len(positions), 4, 64)).astype(np.float32)
    pos = positions.astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_and_softcap_match_reference(name):
    x = np.linspace(-30, 30, 301, dtype=np.float32)
    _close(common.act_fn(name)(torch.from_numpy(x)),
           jcommon.act_fn(name)(jnp.asarray(x)), 1e-5)
    _close(common.softcap(torch.from_numpy(x), 20.0),
           jcommon.softcap(jnp.asarray(x), 20.0), 1e-5)


# ------------------------------------------------------------------- mha
MHA_CASES = [
    # Sq, Sk, H, K, hd, kind, window, chunk, cap
    (24, 24, 4, 2, 32, "causal", 0, 0, 0.0),
    (24, 24, 4, 4, 64, "window", 8, 0, 50.0),
    (40, 40, 4, 2, 32, "chunked", 0, 16, 0.0),
    (20, 20, 4, 2, 32, "bidir", 0, 0, 0.0),
    (1, 37, 4, 1, 128, "causal", 0, 0, 0.0),      # decode against a cache
    (4, 30, 4, 2, 32, "window", 12, 0, 30.0),     # a cached 4-token suffix
    (1, 37, 4, 2, 32, "chunked", 0, 16, 0.0),     # chunked decode
    (2100, 2100, 4, 2, 32, "causal", 0, 0, 0.0),  # the blockwise path ...
    (2100, 2100, 4, 2, 32, "window", 300, 0, 50.0),
    (2100, 2100, 4, 2, 32, "chunked", 0, 512, 0.0),
    # bidir at a whole number of the reference's 1024-key blocks: its
    # blockwise path pads k and v with zero rows that a bidirectional mask
    # does not hide (no model reaches that path: whisper's 1500 frames
    # and llama-vision's 1600 tokens take the dense one)
    (3072, 3072, 4, 2, 32, "bidir", 0, 0, 0.0),
]


@pytest.mark.parametrize("Sq,Sk,H,K,hd,kind,window,chunk,cap", MHA_CASES)
def test_mha_matches_reference(Sq, Sk, H, K, hd, kind, window, chunk, cap):
    """Right-aligned positions, as every caller passes them: the kernel's
    route (its plain version here) for causal, window and bidir, the
    reference's own torch paths for chunked."""
    rng = np.random.default_rng(Sq + Sk + hd)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, Sq, H, hd), (1, Sk, K, hd), (1, Sk, K, hd)))
    kpos = np.arange(Sk, dtype=np.int32)
    qpos = kpos[Sk - Sq:]
    kw = dict(kind=kind, window=window, chunk=chunk, cap=cap)
    want = jattn.mha(*map(jnp.asarray, (q, k, v)), qpos=jnp.asarray(qpos),
                     kpos=jnp.asarray(kpos), **kw)
    got = attention.mha(*map(torch.from_numpy, (q, k, v)),
                        qpos=torch.from_numpy(qpos),
                        kpos=torch.from_numpy(kpos), **kw)
    assert attention.kernel_route(kind, hd, hd) == (kind != "chunked")
    _close(got, want, 1e-5)


def test_mha_bf16_matches_reference():
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), "bfloat16")
        for s in ((2, 16, 8, 64), (2, 16, 2, 64), (2, 16, 2, 64)))
    pos = np.arange(16, dtype=np.int32)
    want = jattn.mha(qj, kj, vj, qpos=jnp.asarray(pos), kpos=jnp.asarray(pos))
    got = attention.mha(qt, kt, vt, qpos=torch.from_numpy(pos),
                        kpos=torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


def test_mha_route_is_fixed_by_mixer_and_widths():
    """MLA (v narrower than q/k) and head widths the kernel does not take
    go to the torch paths; the rest to the kernel."""
    assert attention.kernel_route("causal", 128, 128)
    assert attention.kernel_route("bidir", 64, 64)
    assert not attention.kernel_route("causal", 24, 16)     # MLA, reduced
    assert not attention.kernel_route("causal", 96, 64)     # MLA, minicpm3
    assert not attention.kernel_route("causal", 48, 48)
    assert not attention.kernel_route("chunked", 128, 128)


def test_mha_mla_widths_match_reference():
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((1, 9, 4, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 9, 4, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    want = jattn.mha(*map(jnp.asarray, (q, k, v)), qpos=jnp.asarray(pos),
                     kpos=jnp.asarray(pos), scale=24 ** -0.5)
    got = attention.mha(*map(torch.from_numpy, (q, k, v)),
                        qpos=torch.from_numpy(pos),
                        kpos=torch.from_numpy(pos), scale=24 ** -0.5)
    assert got.shape == (1, 9, 4, 16)
    _close(got, want, 1e-5)


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,di,N", [(2, 40, 24, 8), (1, 300, 64, 16),
                                      (3, 1, 16, 4)])
def test_selective_scan_matches_reference(B, S, di, N, with_h0):
    """y and h_last against `repro.models.mamba.selective_scan` (its
    chunked associative scan; S = 300 spans two of its 256-step chunks),
    with the skip term; h0 from a prefill's state or zeros."""
    rng = np.random.default_rng(B * 1000 + S + di + N)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, di))) * 0.1).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    Bs, Cs = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32) if with_h0 \
        else None
    args = (x, dt, A, Bs, Cs, D)
    y_want, h_want = jmamba.selective_scan(
        *map(jnp.asarray, args), h0=None if h0 is None else jnp.asarray(h0))
    before = ms.launches
    y, h = mamba.selective_scan(*map(torch.from_numpy, args),
                                h0=None if h0 is None
                                else torch.from_numpy(h0))
    assert ms.launches == before                 # CPU: the plain version
    _close(y, y_want, 1e-4)
    _close(h, h_want, 1e-4)


def _layer_params(tree):
    return {k: _layer_params(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_mamba_block_prefill_then_decode_matches_reference():
    """`apply_mamba` on a 10-token prompt into a cache, then 3 decode
    steps through the O(1) update, fp32 compute."""
    cfg = dataclasses.replace(
        registry.reduced(registry.get_config("falcon-mamba-7b")),
        compute_dtype="float32")
    jcfg = dataclasses.replace(
        jregistry.reduced(jregistry.get_config("falcon-mamba-7b")),
        compute_dtype="float32")
    jp = jmamba.init_mamba(jax.random.PRNGKey(3), jcfg)
    tp = _layer_params(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    W, di, N = cfg.ssm.d_conv, cfg.d_inner, cfg.ssm.d_state
    jcache = {"conv": jnp.zeros((2, W - 1, di)),
              "ssm": jnp.zeros((2, di, N))}
    tcache = {"conv": torch.zeros(2, W - 1, di), "ssm": torch.zeros(2, di, N)}
    for a, b in ((0, 10), (10, 11), (11, 12), (12, 13)):
        want, jcache = jmamba.apply_mamba(jp, jnp.asarray(x[:, a:b]), jcfg,
                                          cache=jcache)
        got = mamba.apply_mamba(tp, torch.from_numpy(x[:, a:b]), cfg,
                                cache=tcache)
        _close(got, want, 1e-4)
        _close(tcache["ssm"], jcache["ssm"], 1e-4)
        _close(tcache["conv"], jcache["conv"], 1e-5)


# ------------------------------------------------------------------- moe
@pytest.mark.parametrize("arch,S", [("dbrx-132b", 16), ("dbrx-132b", 1),
                                    ("llama4-scout-17b-a16e", 12),
                                    ("jamba-1.5-large-398b", 9)])
def test_moe_matches_reference(arch, S):
    """The reference's single-device dispatch: capacity drops when S > 1
    (T*K*1.25/E slots an expert), every token kept when S == 1; llama4's
    top-1 with a shared expert."""
    jcfg = dataclasses.replace(jregistry.reduced(jregistry.get_config(arch)),
                               compute_dtype="float32",
                               param_dtype="float32")
    cfg = dataclasses.replace(registry.reduced(registry.get_config(arch)),
                              compute_dtype="float32", param_dtype="float32")
    jp = jmoe.init_moe(jax.random.PRNGKey(S), jcfg)
    tp = _layer_params(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(S).standard_normal(
        (3, S, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(got, want, 1e-5)
    for name in ("moe_aux", "moe_z"):
        _close(aux[name], jaux[name], 1e-5)


def test_mlp_matches_reference():
    jcfg = dataclasses.replace(jregistry.reduced(jregistry.get_config(
        "gemma2-27b")), compute_dtype="float32")
    cfg = dataclasses.replace(registry.reduced(registry.get_config(
        "gemma2-27b")), compute_dtype="float32")
    jp = jmoe.init_mlp(jax.random.PRNGKey(1), jcfg)
    tp = _layer_params(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(1).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    _close(moe.apply_mlp(tp, torch.from_numpy(x), cfg),
           jmoe.apply_mlp(jp, jnp.asarray(x), jcfg), 1e-5)
