"""The port's `kernels.ops` path against the JAX package, on the CPU.

On CPU tensors every wrapper takes its kernel's plain version, so these
cases hold the plain versions, the model-layout wrappers and the oracles
of `repro_torch.kernels` to the reference's Pallas kernels (interpret
mode), `repro.kernels.ops` and `repro.kernels.ref`, at the shapes and
tolerances of tests/test_kernels.py (fp32 attention 2e-5, bf16 2e-2, the
scan 1e-4, tree conv 1e-5). The inputs are made from a seed with numpy and
given to both. The CUDA kernels themselves are checked on the card
(test_torch_kernel_launch.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan  # noqa: E402
from repro.kernels.tree_conv import tree_conv as jax_tree_conv  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops, ref, tree_conv  # noqa: E402

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype="float32"):
    """The same numpy array as a jax and a torch array of `dtype` (both
    round fp32 to bf16 to nearest even)."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(TORCH_DTYPE[dtype]))


def _assert_close(port, want, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------- flash attention
ATTN_CASES = [                          # tests/test_kernels.py's shapes
    (4, 4, 128, 128, 64, 0, 0.0),
    (8, 2, 256, 256, 64, 0, 0.0),       # GQA 4:1
    (4, 4, 100, 100, 32, 0, 0.0),       # unaligned seq
    (2, 2, 1, 300, 64, 0, 0.0),         # decode: 1 query vs cache
    (4, 2, 256, 256, 64, 128, 0.0),     # sliding window
    (4, 4, 128, 128, 64, 0, 50.0),      # gemma softcap
    (4, 4, 64, 192, 64, 0, 0.0),        # suffix queries (Sq < Sk)
]


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,window,cap", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(BH, BKV, Sq, Sk, hd, window,
                                              cap, dtype):
    rng = np.random.default_rng(BH * 1000 + Sq + Sk + hd + window)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((BH, Sq, hd), (BKV, Sk, hd), (BKV, Sk, hd)))
    want = jax_flash_attention(qj, kj, vj, causal=True, window=window,
                               softcap=cap, interpret=True)
    before = fa.launches
    out = fa.flash_attention(qt, kt, vt, causal=True, window=window,
                             softcap=cap)
    assert fa.launches == before               # CPU tensors launch nothing
    assert out.dtype == qt.dtype and out.shape == (BH, Sq, hd)
    _assert_close(out, want, 2e-5 if dtype == "float32" else 2e-2)


# --------------------------------------------------------------- mamba scan
def _scan_inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, di)).astype(np.float32),
            (np.abs(rng.standard_normal((B, S, di))) * 0.1).astype(np.float32),
            -np.abs(rng.standard_normal((di, N))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32)]


@pytest.mark.parametrize("B,S,di,N,chunk,bd", [
    (2, 64, 32, 8, 32, 32),
    (1, 100, 64, 16, 32, 32),           # unaligned time
    (2, 256, 96, 16, 128, 32),          # unaligned channels
    (1, 96, 32, 8, 16, 32),             # the chunk-invariance case ...
    (1, 96, 32, 8, 96, 16),             # ... at both of its chunkings
])
def test_mamba_scan_plain_matches_pallas(B, S, di, N, chunk, bd):
    """The port has no chunk: its one result matches the Pallas kernel at
    every chunking the reference tests."""
    args = _scan_inputs(B, S, di, N, seed=B * 1000 + S + di)
    want = jax_mamba_scan(*map(jnp.asarray, args), chunk=chunk, block_d=bd,
                          interpret=True)
    before = ms.launches
    out, _ = ms.mamba_scan(*map(torch.from_numpy, args))
    assert ms.launches == before
    _assert_close(out, want, 1e-4)


@pytest.mark.parametrize("N,lanes", [(16, 1), (16, 2), (16, 4), (16, 8),
                                     (16, 16), (4, 4), (8, 4), (32, 16)])
def test_mamba_scan_lanes_plain_matches_pallas(N, lanes):
    """The scan kernel's order of sums (states split over `lanes` lanes,
    then the butterfly over the lanes) against the Pallas kernel, at every
    lane count the kernel can take and at one lane (the sequential sum)."""
    args = _scan_inputs(2, 70, 40, N, seed=N * 100 + lanes)
    want = jax_mamba_scan(*map(jnp.asarray, args), chunk=32, block_d=40,
                          interpret=True)
    out = ref.mamba_scan_lanes_ref(*map(torch.from_numpy, args), lanes=lanes)
    _assert_close(out, want, 1e-4)


@pytest.mark.parametrize("lanes", [0, 3, 32])
def test_mamba_scan_lanes_ref_rejects_other_lane_counts(lanes):
    """Lane counts must be powers of two that divide N (here 16)."""
    with pytest.raises(ValueError, match="lanes"):
        ref.mamba_scan_lanes_ref(*map(torch.from_numpy,
                                      _scan_inputs(1, 4, 8, 16, seed=0)),
                                 lanes=lanes)


@pytest.mark.parametrize("B,S,di,N", [(1, 33, 40, 4), (3, 31, 24, 16),
                                      (2, 1, 16, 32)])
def test_selective_scan_fused_skip_matches_reference_ops(B, S, di, N):
    """The skip term the kernel now adds (mamba_scan's D) against
    repro.kernels.ops.selective_scan_fused, the h_last the port's wrapper
    also returns against the reference's oracle, and mamba_scan without D
    against the Pallas kernel alone."""
    args = _scan_inputs(B, S, di, N, seed=B * 100 + S + di + N)
    D = np.random.default_rng(N).standard_normal(di).astype(np.float32)
    want = jops.selective_scan_fused(*map(jnp.asarray, args), jnp.asarray(D),
                                     chunk=16, interpret=True)
    before = ms.launches
    targs = list(map(torch.from_numpy, args))
    out, h = ops.selective_scan_fused(*targs, torch.from_numpy(D))
    _assert_close(out, want, 1e-4)
    _assert_close(h, jref.mamba_scan_ref(*map(jnp.asarray, args))[1], 1e-4)
    _assert_close(ms.mamba_scan(*targs, D=torch.from_numpy(D))[0], want,
                  1e-4)
    _assert_close(ms.mamba_scan(*targs)[0],
                  jax_mamba_scan(*map(jnp.asarray, args), chunk=16,
                                 interpret=True), 1e-4)
    assert ms.launches == before


@pytest.mark.parametrize("S", [1, 37])
def test_mamba_scan_state_matches_reference_oracle(S):
    """`mamba_scan` from a given h0: y and h_last against
    the reference's `mamba_scan_ref(h0=...)`; a prefill's h_last carried
    into a second call continues the scan."""
    args = _scan_inputs(2, S, 24, 8, seed=S)
    h0 = np.random.default_rng(S + 1).standard_normal(
        (2, 24, 8)).astype(np.float32)
    y_want, h_want = jref.mamba_scan_ref(*map(jnp.asarray, args),
                                         jnp.asarray(h0))
    targs = list(map(torch.from_numpy, args))
    y, h = ms.mamba_scan(*targs, h0=torch.from_numpy(h0))
    _assert_close(y, y_want, 1e-4)
    _assert_close(h, h_want, 1e-4)
    if S > 1:
        cut = S // 2
        first = [t[:, :cut].contiguous() if t.dim() == 3 and t.shape[1] == S
                 else t for t in targs]
        rest = [t[:, cut:].contiguous() if t.dim() == 3 and t.shape[1] == S
                else t for t in targs]
        _, h1 = ms.mamba_scan(*first, h0=torch.from_numpy(h0))
        y2, h2 = ms.mamba_scan(*rest, h0=h1)
        _assert_close(y2, np.asarray(y_want)[:, cut:], 1e-4)
        _assert_close(h2, h_want, 1e-4)


def test_mamba_scan_checks_the_skip_weights():
    targs = list(map(torch.from_numpy, _scan_inputs(1, 8, 16, 4, seed=1)))
    with pytest.raises(ValueError, match="D must have shape"):
        ms.mamba_scan(*targs, D=torch.zeros(8))
    with pytest.raises(TypeError, match="D must be"):
        ms.mamba_scan(*targs, D=torch.zeros(16, dtype=torch.float64))
    with pytest.raises(ValueError, match="h0 must have shape"):
        ms.mamba_scan(*targs, h0=torch.zeros(1, 16, 8))


# ---------------------------------------------------------------- tree conv
def _tree_inputs(Bt, N, F, H, seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((Bt, N, F)).astype(np.float32)
    feat[:, 0] = 0.0                                   # null slot
    lo, hi = (-3, N + 3) if out_of_range else (0, N)
    left = rng.integers(lo, hi, (Bt, N)).astype(np.int32)
    right = rng.integers(lo, hi, (Bt, N)).astype(np.int32)
    mask = (rng.random((Bt, N)) > 0.3).astype(np.float32)
    mask[:, 0] = 0.0
    ws = [rng.standard_normal((F, H)).astype(np.float32) * 0.1
          for _ in range(3)]
    b = rng.standard_normal(H).astype(np.float32) * 0.1
    return [feat, left, right, mask, *ws, b]


@pytest.mark.parametrize("Bt,N,F,H,oob", [(3, 16, 8, 12, False),
                                          (2, 64, 27, 96, False),
                                          (1, 64, 30, 64, False),
                                          (4, 48, 26, 96, True)])
def test_tree_conv_plain_matches_pallas(Bt, N, F, H, oob):
    """`oob`: child indices >= N and < 0, which the Pallas kernel's one-hot
    reads as zero rows."""
    args = _tree_inputs(Bt, N, F, H, seed=Bt * 1000 + N + F + H,
                        out_of_range=oob)
    want = jax_tree_conv(*map(jnp.asarray, args), interpret=True)
    before = tree_conv.tree_conv_launches
    out = tree_conv.tree_conv(*map(torch.from_numpy, args))
    assert tree_conv.tree_conv_launches == before
    _assert_close(out, want, 1e-5)


# ---------------------------------------------------- model-layout wrappers
def _ops_case(name):
    rng = np.random.default_rng(len(name))
    if name == "mha_flash":
        B, S, H, K, hd = 2, 64, 8, 2, 32
        args = [rng.standard_normal(s).astype(np.float32)
                for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]
        kw = {"causal": True, "window": 24, "softcap": 30.0}
        return args, {}, kw, 2e-5
    if name == "selective_scan_fused":
        args = _scan_inputs(2, 80, 48, 16, seed=5)
        args.append(rng.standard_normal(48).astype(np.float32))
        return args, {}, {}, 1e-4
    args = _tree_inputs(3, 32, 12, 20, seed=6, out_of_range=True)
    feat, left, right, mask, wr, wl, wrt, b = args
    return ([feat, left, right, mask],
            {"wr": wr, "wl": wl, "wrt": wrt, "b": b}, {}, 1e-5)


@pytest.mark.parametrize("name", ["mha_flash", "selective_scan_fused",
                                  "tree_conv_batch"])
def test_ops_wrapper_matches_reference_ops(name):
    args, params, kw, tol = _ops_case(name)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if params:
        jargs.append({k: jnp.asarray(v) for k, v in params.items()})
        targs.append({k: torch.from_numpy(v) for k, v in params.items()})
    want = getattr(jops, name)(*jargs, interpret=True, **kw)
    out = getattr(ops, name)(*targs, **kw)
    if name == "selective_scan_fused":        # the port's adds h_last
        out = out[0]
    assert out.shape == want.shape
    assert out.dtype == TORCH_DTYPE[str(want.dtype)]
    _assert_close(out, want, tol)


# ------------------------------------------------------------------ oracles
@pytest.mark.parametrize("Sq,Sk,causal,window,cap", [
    (96, 96, True, 0, 0.0), (64, 160, True, 32, 0.0),
    (80, 48, True, 0, 20.0),            # Sq > Sk: fully-masked rows -> 0
    (50, 70, False, 16, 0.0)])
def test_flash_attention_oracle_matches_reference(Sq, Sk, causal, window,
                                                  cap):
    rng = np.random.default_rng(Sq + Sk)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32))
        for s in ((3, Sq, 32), (3, Sk, 32), (3, Sk, 32)))
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window,
                                    softcap=cap)
    out = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                  softcap=cap)
    _assert_close(out, want, 2e-5)
    if Sq > Sk:
        assert not out[:, :Sq - Sk].any()


@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_oracle_matches_reference(with_h0):
    args = _scan_inputs(2, 40, 24, 8, seed=7)
    h0 = (np.random.default_rng(8).standard_normal((2, 24, 8))
          .astype(np.float32) if with_h0 else None)
    y_want, h_want = jref.mamba_scan_ref(
        *map(jnp.asarray, args), None if h0 is None else jnp.asarray(h0))
    y, h = ref.mamba_scan_ref(*map(torch.from_numpy, args),
                              None if h0 is None else torch.from_numpy(h0))
    _assert_close(y, y_want, 1e-4)
    _assert_close(h, h_want, 1e-4)


@pytest.mark.parametrize("oob", [False, True])
def test_tree_conv_oracle_matches_reference(oob):
    """`oob`: the oracle's `h[idx]` clamps an index past the end and counts
    a negative one from the end, as jnp indexing does."""
    feat, left, right, mask, wr, wl, wrt, b = _tree_inputs(
        1, 24, 10, 16, seed=9, out_of_range=oob)
    if oob:
        left[0, :4] = [-1, -24, -27, 30]               # wrap, wrap, clamp
    args = [feat[0], left[0], right[0], mask[0], wr, wl, wrt, b]
    want = jref.tree_conv_ref(*map(jnp.asarray, args))
    out = ref.tree_conv_ref(*map(torch.from_numpy, args))
    _assert_close(out, want, 1e-5)


# ------------------------------------- the decode kernel's split-key merge
SPLIT_EXTRA = [                         # beyond tests/test_kernels.py's
    (2, 2, 1, 300, 64, 64, 0.0),        # window: 6 of 8 splits see no key
    (4, 1, 4, 130, 32, 0, 30.0),        # Sq*G = 16 rows, 130 keys, softcap
    (2, 1, 80, 48, 32, 0, 0.0),         # Sq > Sk: rows with no key -> 0
]


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,window,cap",
                         ATTN_CASES + SPLIT_EXTRA)
def test_flash_attention_split_merge_matches_pallas(BH, BKV, Sq, Sk, hd,
                                                    window, cap, splits):
    """The decode kernel's algorithm (one partial per key split, merged by
    log-sum-exp) against the Pallas kernel, fp32."""
    rng = np.random.default_rng(BH * 1000 + Sq + Sk + hd + window)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32))
        for s in ((BH, Sq, hd), (BKV, Sk, hd), (BKV, Sk, hd)))
    want = jax_flash_attention(qj, kj, vj, causal=True, window=window,
                               softcap=cap, interpret=True)
    out = ref.flash_attention_split_ref(qt, kt, vt, causal=True,
                                        window=window, softcap=cap,
                                        splits=splits, tile=fa.DECODE_TILE)
    _assert_close(out, want, 2e-5)
    if Sq > Sk:
        assert not out[:, :Sq - Sk].any()


def test_split_key_ranges_cover_the_allowed_keys_once():
    ranges = ref.split_key_ranges(1, 300, causal=True, window=64, splits=8,
                                  tile=64)
    live = [(a, b) for a, b in ranges if b > a]
    assert live == [(192, 256), (256, 300)]       # keys 236..299 allowed
    assert len(ranges) - len(live) == 6
    ranges = ref.split_key_ranges(1, 4096, causal=True, window=0,
                                  splits=fa.DECODE_SPLITS,
                                  tile=fa.DECODE_TILE)    # qwen3-8b decode
    assert ranges == [(512 * c, 512 * (c + 1)) for c in range(8)]
    assert all(b <= a for a, b in ref.split_key_ranges(
        3, 0, causal=True, window=0, splits=8, tile=64))


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_path_of_every_chip_smoke_attention_case():
    want = {"qwen3-8b/prefill": "wgmma", "qwen3-8b/decode": "decode",
            "gemma2-27b/local": "wgmma", "qwen3-8b/fp32": "fp32",
            "gemma2-27b/decode-local": "decode",
            "qwen3-8b/suffix4": "decode"}
    got = {}
    for case, B, Sq, Sk, H, K, hd, *_, dtype, _a, _r, _s in \
            _chip_smoke().ATTENTION_CASES:
        got[case] = fa.kernel_path(B * H, B * K, Sq, Sk, hd, dtype)
    assert got == want


def _attn_long_rows():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "attn_long_rows.py"
    spec = importlib.util.spec_from_file_location("attn_long_rows", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("BH,BKV,Sq,Sk,causal,window,cap", [
    (4, 2, 40, 40, True, 0, 0.0),
    (6, 2, 24, 70, True, 16, 30.0),      # right-aligned, window, softcap
    (4, 4, 30, 50, False, 0, 0.0),       # bidirectional
])
def test_chip_smoke_flash_algorithm_is_the_plain_versions(BH, BKV, Sq, Sk,
                                                          causal, window,
                                                          cap):
    """tools/attn_long_rows.py's `Flash`, the bf16 kernels' algorithm in
    torch that the tool holds chip_smoke.py's train_lm superblocks
    against, is without its roundings the plain forward and the plain
    backward from the forward's logsumexp (fp32, 1e-5); its roundings move
    the output and each gradient, by less than 1e-2 of their norms."""
    cs = _attn_long_rows()
    gen = torch.Generator().manual_seed(BH + Sq)
    q, out_g = (torch.randn((BH, Sq, 32), generator=gen) for _ in range(2))
    k, v = (torch.randn((BKV, Sk, 32), generator=gen) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    args = (causal, window, cap, 32 ** -0.5)
    want, lse = ref.flash_attention_ref(q, k, v, **kw, return_lse=True)
    want_g = ref.flash_attention_bwd_ref(q, k, v, want, out_g, **kw,
                                         lse=lse)
    out, lse_f = cs.flash_fwd(q, k, v, *args, False)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse_f, lse, atol=1e-5, rtol=1e-5)
    for g, w in zip(cs.flash_bwd(q, k, v, want, out_g, lse, *args, False),
                    want_g):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    rounded = [cs.flash_fwd(q, k, v, *args, True)[0],
               *cs.flash_bwd(q, k, v, want, out_g, lse, *args, True)]
    for r, w in zip(rounded, [want, *want_g]):
        rel = float((r - w).norm() / w.norm())
        assert 0 < rel < 1e-2


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,dtype,path", [
    (32, 8, 4, 64, 128, torch.bfloat16, "decode"),     # 16 rows: the edge
    (32, 8, 5, 64, 128, torch.bfloat16, "wgmma"),      # 20 rows
    (8, 8, 16, 16, 32, torch.bfloat16, "decode"),
    (8, 1, 2, 9, 64, torch.bfloat16, "decode"),
    (8, 1, 3, 9, 64, torch.bfloat16, "wgmma"),
    (4, 4, 1, 0, 64, torch.bfloat16, "decode"),        # no keys: zeros
    (4, 4, 1, 8, 64, torch.float32, "fp32"),
])
def test_kernel_path_dispatch(BH, BKV, Sq, Sk, hd, dtype, path):
    assert fa.kernel_path(BH, BKV, Sq, Sk, hd, dtype) == path


@pytest.mark.parametrize("BH,BKV,Sq,Sk,hd,dtype", [
    (4, 4, 64, 64, 48, torch.bfloat16),                # no such width
    (4, 4, 64, 0, 64, torch.bfloat16),                 # wgmma needs keys
    (70000, 1, 64, 64, 64, torch.float32),             # grid too tall
])
def test_kernel_path_raises_for_shapes_no_kernel_takes(BH, BKV, Sq, Sk, hd,
                                                       dtype):
    with pytest.raises(ValueError):
        fa.kernel_path(BH, BKV, Sq, Sk, hd, dtype)
