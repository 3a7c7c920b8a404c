"""Launch hygiene of the port's CUDA kernels, on the card only.

Run there with `python -m pytest -q -m gpu tests/test_torch_kernel_launch.py`;
elsewhere every test skips. This file imports no jax: the machine with the
card has none.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.core.nets import TreeCNN  # noqa: E402
from repro_torch.kernels import ref, tree_conv  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B=8, N=48, F=26, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, N, F)).astype(np.float32)
    left = rng.integers(-2, N + 2, (B, N)).astype(np.int32)
    right = rng.integers(-2, N + 2, (B, N)).astype(np.int32)
    mask = (rng.random((B, N)) > 0.3).astype(np.float32)
    mask[-1] = 0.0
    return [torch.from_numpy(x) for x in (feat, left, right, mask)]


def test_mixed_devices_raise(cuda):
    enc = TreeCNN(26, 96, prng.prng_key(0)).to(cuda)
    feat, left, right, mask = _inputs()
    with pytest.raises(ValueError, match="is on"):
        tree_conv.tree_cnn_fused(feat.to(cuda), left, right.to(cuda),
                                 mask.to(cuda), enc.params())
    with torch.inference_mode(), pytest.raises(ValueError, match="is on"):
        tree_conv.tree_cnn_fused(feat, left, right, mask, enc.params())


def test_wrong_dtype_or_layout_raises_on_card(cuda):
    enc = TreeCNN(26, 96, prng.prng_key(0)).to(cuda)
    feat, left, right, mask = (t.to(cuda) for t in _inputs())
    with torch.inference_mode():
        with pytest.raises(TypeError):
            tree_conv.tree_cnn_fused(feat, left.long(), right, mask,
                                     enc.params())
        with pytest.raises(TypeError):
            tree_conv.tree_cnn_fused(feat.half(), left, right, mask,
                                     enc.params())
        strided = feat.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            tree_conv.tree_cnn_fused(strided, left, right, mask,
                                     enc.params())


@pytest.mark.parametrize("B,N,F,H", [(8, 48, 26, 96), (5, 16, 26, 96),
                                     (8, 64, 26, 96), (3, 40, 9, 40),
                                     (2, 64, 27, 128)])
def test_one_launch_per_encoder_call(cuda, B, N, F, H):
    enc = TreeCNN(F, H, prng.prng_key(1)).to(cuda)
    feat, left, right, mask = (t.to(cuda) for t in _inputs(B, N, F))
    with torch.inference_mode():
        before = tree_conv.tree_cnn_fused_launches
        out = enc(feat, left, right, mask)
        assert tree_conv.tree_cnn_fused_launches == before + 1
        single = enc(feat[0], left[0], right[0], mask[0])
        assert tree_conv.tree_cnn_fused_launches == before + 2
        want = ref.tree_cnn_fused_ref(feat, left, right, mask, enc.params())
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    assert float((out - want).abs().max()) <= 1e-4
    assert float((single - want[0]).abs().max()) <= 1e-4
    assert not out[-1].any()


def test_act_batch_launches_the_kernel_once(cuda):
    meta = WorkloadMeta({f"t{i}": i for i in range(20)}, 17)
    agent = AqoraAgent(meta, AgentConfig(), seed=0)      # default: CUDA
    assert agent.device.type == "cuda"
    feat, left, right, mask = (t.numpy() for t in _inputs(8, 64, 26))
    left = np.clip(left, 0, 63)
    right = np.clip(right, 0, 63)
    amask = np.ones((8, agent.space.d), np.float32)
    keys = np.zeros((8, 2), np.uint32)
    before = tree_conv.tree_cnn_fused_launches
    a, logp, _ = agent.act_batch(feat, left, right, mask, amask, keys,
                                 explore=False)
    assert tree_conv.tree_cnn_fused_launches == before + 1
    assert a.shape == (8,) and np.isfinite(logp).all()


# ------------------------------------------- the fused encoder's backward
# weight grads sum over every node and tree in another order than the
# plain version's: 1e-5 + 1e-4 |plain|; the input grads likewise
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4


def _bwd_case(cuda, B, N, F, H, seed, tie=False, scale=10):
    feat, left, right, mask = _inputs(B, N, F, seed)
    if tie:            # node 2 repeats node 1: tied maxima in every channel
        feat[:, 2] = feat[:, 1] * scale
        feat[:, 1] = feat[:, 2]
        left[:, 2], right[:, 2] = left[:, 1], right[:, 1]
        mask[:-1, 1:3] = 1.0
    enc = TreeCNN(F, H, prng.prng_key(seed)).to(cuda)
    gen = torch.Generator(cuda).manual_seed(seed)    # the biases, seeded
    with torch.no_grad():
        for lname in tree_conv.LAYERS:
            b = getattr(enc, lname).b
            b.copy_(torch.randn(b.shape, generator=gen, device=cuda) * 0.1)
    params = {l: {w: t.detach() for w, t in ws.items()}
              for l, ws in enc.params().items()}
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, H)).astype(np.float32))
    return [t.to(cuda) for t in (feat, left, right, mask)], params, g.to(cuda)


def _bwd_close(got, want):
    """Every output within BWD_ATOL + BWD_RTOL |want|; a failure names the
    output and the share of its limit it takes."""
    gf, gm, gp = got
    wf, wm, wp = want
    pairs = [("gfeat", gf, wf), ("gmask", gm, wm)] + [
        (f"{l}/{w}", gp[l][w], wp[l][w])
        for l in tree_conv.LAYERS for w in tree_conv.WEIGHTS]
    for name, out, ref_ in pairs:
        assert out.shape == ref_.shape and torch.isfinite(out).all(), name
        share = float(((out.float() - ref_.float()).abs()
                       / (BWD_ATOL + BWD_RTOL * ref_.float().abs())).max())
        assert share <= 1.0, f"{name}: {share} of the limit"


@pytest.mark.parametrize("B,N,F,H,tie", [
    (24, 48, 26, 96, False), (32, 48, 26, 96, False),   # the PPO shapes
    (8, 16, 26, 96, False), (5, 64, 26, 96, False), (8, 32, 26, 96, True),
    (3, 40, 9, 40, False), (2, 64, 128, 128, False), (4, 33, 27, 100, True)])
def test_fused_backward_matches_plain(cuda, B, N, F, H, tie):
    """Random trees with out-of-range children and an all-masked tree,
    one backward call: gfeat, gmask and the 12 weight grads within
    1e-5 + 1e-4 |plain|."""
    (feat, left, right, mask), params, g = _bwd_case(cuda, B, N, F, H,
                                                     seed=B + N, tie=tie)
    before = tree_conv.tree_cnn_fused_bwd_launches
    got = tree_conv.tree_cnn_fused_backward(feat, left, right, mask, params, g)
    assert tree_conv.tree_cnn_fused_bwd_launches == before + 2
    want = ref.tree_cnn_fused_bwd_ref(feat, left, right, mask, params, g)
    torch.cuda.synchronize()
    _bwd_close(got, want)
    assert not got[0][-1].any() and not got[1][-1].any()


def _tied_channels(feat, left, right, mask, params):
    """(tree, channel) pairs whose max-pool has more than one maximum, by
    the plain version's layers."""
    m = mask.unsqueeze(-1)

    def layer(h, p):
        return ref.tree_layer(h, left, right, m,
                              *(p[w] for w in tree_conv.WEIGHTS))
    h1 = layer(feat * m, params["conv1"])
    h2 = layer(h1, params["conv2"])
    h3 = torch.where(m > 0, layer(h2, params["conv3"]) + h2, -torch.inf)
    top = h3.amax(dim=1, keepdim=True)
    return int((((h3 == top) & (m > 0)).sum(dim=1) > 1).sum())


@pytest.mark.parametrize("F", [26, 128])
@pytest.mark.parametrize("H", [64, 96, 128])
@pytest.mark.parametrize("N", [1, 16, 48, 64])
@pytest.mark.parametrize("B", [1, 24, 32, 33])
def test_fused_backward_cluster_edges(cuda, B, N, F, H):
    """The cluster kernel at its edges: one tree or more trees than the
    card holds at once with one block an SM, one node or the node limit,
    channel slices of 16 to 32, a ragged F slice (26) and the
    widest input (128); trees in which node 2 repeats node 1 at twice its
    features (N >= 3; tied maxima in some channels of every batch of more
    than one tree) and an all-masked tree (B > 1). One
    call, two launches, every output within 1e-5 + 1e-4 |plain|. (At ten
    times the features, as `_bwd_case` scales its own tied cases, the
    fp32 plain version itself strays past this limit, up to 1.7 times it,
    from the fp64 one on 16-node trees, so another summation order cannot
    be held to it there.)"""
    (feat, left, right, mask), params, g = _bwd_case(
        cuda, B, N, F, H, seed=B * N + H + F, tie=N >= 3, scale=2)
    if B == 1:
        mask[0, : min(N, 2)] = 1.0      # the one tree is not all-masked
    if N >= 3 and B > 1:
        assert _tied_channels(feat, left, right, mask, params) > 0
    before = tree_conv.tree_cnn_fused_bwd_launches
    got = tree_conv.tree_cnn_fused_backward(feat, left, right, mask, params, g)
    assert tree_conv.tree_cnn_fused_bwd_launches == before + 2
    want = ref.tree_cnn_fused_bwd_ref(feat, left, right, mask, params, g)
    torch.cuda.synchronize()
    _bwd_close(got, want)
    if B > 1:
        assert not got[0][-1].any() and not got[1][-1].any()


@pytest.mark.parametrize("B,N,H,F", [(33, 16, 128, 26), (24, 48, 96, 26)])
def test_fused_backward_edges_repeat(cuda, B, N, H, F):
    """The two edge cases that failed now and then while the biases came
    from the unseeded global generator (ROADMAP Queue C), 20 times on
    inputs built afresh each time from the case's seed: the inputs are
    the same every time, the kernel's outputs bit for bit, and every
    output within the unchanged 1e-5 + 1e-4 |plain| of the plain
    version's (whose atomic gather backward moves in the last bits)."""
    first = None
    for _ in range(20):
        (feat, left, right, mask), params, g = _bwd_case(
            cuda, B, N, F, H, seed=B * N + H + F, tie=True, scale=2)
        got = tree_conv.tree_cnn_fused_backward(feat, left, right, mask,
                                                params, g)
        want = ref.tree_cnn_fused_bwd_ref(feat, left, right, mask, params,
                                          g)
        torch.cuda.synchronize()
        _bwd_close(got, want)
        flat = [feat, params["conv3"]["b"], got[0], got[1]] + [
            got[2][l][w] for l in tree_conv.LAYERS for w in tree_conv.WEIGHTS]
        if first is None:
            first = [t.clone() for t in flat]
        assert all(torch.equal(a, b) for a, b in zip(first, flat))


def test_backward_occupancy(cuda):
    """At the PPO shape two 4-block clusters share the SMs, so the card
    holds the critic's 32 trees at once; the widest shape fits too."""
    occ = tree_conv.backward_occupancy(48, 26, 96)
    assert occ["cluster"] == 4 and occ["blocks_per_sm"] == 2
    assert occ["max_active_clusters"] >= 32
    assert tree_conv.backward_occupancy(64, 128, 128)[
        "max_active_clusters"] >= 1


def test_fused_backward_repeats_bit_for_bit(cuda):
    (feat, left, right, mask), params, g = _bwd_case(cuda, 24, 48, 26, 96, 5)
    first = tree_conv.tree_cnn_fused_backward(feat, left, right, mask,
                                              params, g)
    first = [first[0].clone(), first[1].clone(),
             {l: {w: t.clone() for w, t in ws.items()}
              for l, ws in first[2].items()}]
    for _ in range(3):
        again = tree_conv.tree_cnn_fused_backward(feat, left, right, mask,
                                                  params, g)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
        for l in tree_conv.LAYERS:
            for w in tree_conv.WEIGHTS:
                assert torch.equal(again[2][l][w], first[2][l][w])


def test_autograd_goes_through_both_kernels(cuda):
    """A loss through the encoder on the card: one forward launch, one
    backward call (two launches), grads only where asked, and no plain
    version."""
    (feat, left, right, mask), params, g = _bwd_case(cuda, 8, 48, 26, 96, 9)
    w = {l: {n: t.clone().requires_grad_(True) for n, t in ws.items()}
         for l, ws in params.items()}
    f0, b0 = tree_conv.tree_cnn_fused_launches, \
        tree_conv.tree_cnn_fused_bwd_launches
    out = tree_conv.tree_cnn_fused(feat, left, right, mask, w)
    (out * g).sum().backward()
    assert tree_conv.tree_cnn_fused_launches == f0 + 1
    assert tree_conv.tree_cnn_fused_bwd_launches == b0 + 2
    want = ref.tree_cnn_fused_bwd_ref(feat, left, right, mask, params, g)
    for l in tree_conv.LAYERS:
        for n in tree_conv.WEIGHTS:
            _close(w[l][n].grad, want[2][l][n], BWD_ATOL, BWD_RTOL)
    ff = feat.clone().requires_grad_(True)
    out = tree_conv.tree_cnn_fused(ff, left, right, mask, params)
    (out * g).sum().backward()
    _close(ff.grad, want[0], BWD_ATOL, BWD_RTOL)


def test_ppo_update_on_the_card(cuda):
    """One PPO update of the CUDA agent launches the forward 1 + 2 e
    times and calls the backward 2 e times (4 e launches) and moves the
    actor."""
    from repro_torch.core.rollout import Trajectory
    meta = WorkloadMeta({f"t{i}": i for i in range(20)}, 17)
    agent = AqoraAgent(meta, AgentConfig(), seed=0)
    feat, left, right, mask = (t.numpy() for t in _inputs(6, 64, 26, 3))
    mask[:, 40:] = 0.0
    left, right = np.clip(left, 0, 39), np.clip(right, 0, 39)
    trajs = []
    for b in range(2):
        t = Trajectory()
        for i in range(3):
            s = 3 * b + i
            t.states.append((feat[s], left[s], right[s], mask[s]))
        amask = np.ones(agent.space.d, np.float32)
        t.actions, t.logps = [1, 2], [-5.0, -5.1]
        t.masks, t.rewards, t.t_execute = [amask, amask], [0.5, -0.25], 30.0
        trajs.append(t)
    before = [p.detach().clone() for p in agent.actor.parameters()]
    f0, b0 = tree_conv.tree_cnn_fused_launches, \
        tree_conv.tree_cnn_fused_bwd_launches
    m = agent.ppo_update_batch(trajs)
    e = agent.cfg.ppo_epochs
    assert tree_conv.tree_cnn_fused_launches == f0 + 1 + 2 * e
    assert tree_conv.tree_cnn_fused_bwd_launches == b0 + 4 * e
    assert np.isfinite(m["actor_loss"]) and np.isfinite(m["critic_loss"])
    assert any(not torch.equal(a, b) for a, b in
               zip(before, agent.actor.parameters()))
    assert int(agent.aopt["step"]) == e


# ------------------------------------------------- the kernels.ops kernels
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _close(out, want, tol, rtol=None):
    """|out - want| <= tol + rtol * |want| everywhere (rtol defaults to
    tol)."""
    out, want = out.float(), want.float()
    assert out.shape == want.shape
    assert torch.isfinite(out).all()
    rtol = tol if rtol is None else rtol
    bad = (out - want).abs() > tol + rtol * want.abs()
    assert not bad.any(), float((out - want).abs().max())


# bf16 attention: rtol covers one rounding of the output (2^-7 |x|), atol
# P rounded to bf16 for the P.V product (at most 2^-9 of a weighted mean
# of |v|); a dropped 64-key tile moves these outputs by far more
BF16_ATOL, BF16_RTOL = 4e-3, 1e-2


def _attn(B, Sq, Sk, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((B, Sq, H, hd), (B, Sk, K, hd),
                                 (B, Sk, K, hd))]


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window,cap", [
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),
    (2, 256, 256, 8, 2, 64, True, 0, 0.0),        # GQA 4:1
    (1, 100, 100, 4, 4, 32, True, 0, 0.0),        # unaligned
    (2, 1, 300, 4, 2, 128, True, 0, 0.0),         # decode, right-aligned
    (1, 256, 256, 4, 2, 64, True, 128, 0.0),      # sliding window
    (1, 128, 128, 4, 4, 128, True, 0, 50.0),      # softcap
    (1, 64, 192, 4, 4, 64, True, 0, 0.0),         # suffix queries
    (1, 200, 70, 2, 1, 32, True, 0, 0.0),         # Sq > Sk: masked rows
    (1, 96, 130, 2, 2, 64, False, 0, 0.0),        # not causal
    (1, 150, 150, 2, 1, 128, False, 40, 30.0),    # window only, softcap
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_one_launch_per_call(cuda, B, Sq, Sk, H, K, hd,
                                             causal, window, cap, dtype):
    q, k, v = (t.to(cuda) for t in _attn(B, Sq, Sk, H, K, hd, dtype))
    with torch.inference_mode():
        before = fa.launches
        out = ops.mha_flash(q, k, v, causal=causal, window=window,
                            softcap=cap)
        assert fa.launches == before + 1
        qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
        kf = k.transpose(1, 2).reshape(B * K, Sk, hd)
        vf = v.transpose(1, 2).reshape(B * K, Sk, hd)
        want = ref.flash_attention_ref(qf, kf, vf, causal=causal,
                                       window=window, softcap=cap)
        want = want.reshape(B, H, Sq, hd).transpose(1, 2)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    if dtype == torch.float32:
        _close(out, want, 2e-5)
    else:
        _close(out, want, BF16_ATOL, BF16_RTOL)


def _attention_case(cuda, B, Sq, Sk, H, K, hd, causal, window, cap, path):
    """One bf16 mha_flash call on the card: the path `kernel_path` takes,
    one launch, agreement with the plain version."""
    q, k, v = (t.to(cuda) for t in _attn(B, Sq, Sk, H, K, hd,
                                           torch.bfloat16, seed=Sk + H))
    assert fa.kernel_path(B * H, B * K, Sq, Sk, hd, q.dtype) == path
    with torch.inference_mode():
        before = fa.launches
        out = ops.mha_flash(q, k, v, causal=causal, window=window,
                            softcap=cap)
        assert fa.launches == before + 1
        qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
        kf = k.transpose(1, 2).reshape(B * K, Sk, hd)
        vf = v.transpose(1, 2).reshape(B * K, Sk, hd)
        want = ref.flash_attention_ref(qf, kf, vf, causal=causal,
                                       window=window, softcap=cap)
        want = want.reshape(B, H, Sq, hd).transpose(1, 2)
    torch.cuda.synchronize()
    _close(out, want, BF16_ATOL, BF16_RTOL)
    return out


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_decode_packs_the_gqa_group(cuda, G, hd):
    _attention_case(cuda, 2, 1, 300, 2 * G, 2, hd, True, 0, 0.0, "decode")


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window,cap,path", [
    (1, 4, 200, 16, 4, 64, True, 0, 0.0, "decode"),    # Sq*G = 16: the edge
    (1, 2, 200, 16, 2, 64, True, 0, 0.0, "decode"),    # 8 * 2 = 16
    (1, 5, 200, 16, 4, 64, True, 0, 0.0, "wgmma"),     # 20 rows: past it
    (2, 1, 1000, 8, 2, 128, True, 0, 0.0, "decode"),   # 16 tiles, 8 splits
    (2, 3, 100, 4, 4, 128, True, 0, 0.0, "decode"),    # Sk % 64 != 0
    (1, 1, 4099, 4, 1, 128, False, 0, 30.0, "decode"),  # softcap, no mask
    (2, 1, 300, 8, 2, 64, True, 64, 0.0, "decode"),    # 6 splits keyless
    (1, 2, 9000, 4, 2, 128, True, 32, 50.0, "decode"),  # one split live
    (1, 8, 5, 2, 1, 64, True, 0, 0.0, "decode"),       # Sq > Sk
    (1, 300, 100, 4, 2, 128, True, 0, 0.0, "wgmma"),   # Sq > Sk
])
def test_decode_and_edge_paths(cuda, B, Sq, Sk, H, K, hd, causal, window,
                               cap, path):
    out = _attention_case(cuda, B, Sq, Sk, H, K, hd, causal, window, cap,
                          path)
    if Sq > Sk:                                # rows with no key give 0
        assert not out[:, :Sq - Sk].any()


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal,window,cap", [
    (512, 512, True, 0, 0.0),
    (384, 700, True, 200, 30.0),              # window across tiles, softcap
    (130, 130, False, 0, 0.0),                # ragged last tile, no mask
])
def test_wgmma_path_every_head_width(cuda, hd, Sq, Sk, causal, window, cap):
    _attention_case(cuda, 1, Sq, Sk, 4, 2, hd, causal, window, cap, "wgmma")


def _scan(B, S, di, N, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((B, S, di)),
        np.abs(rng.standard_normal((B, S, di))) * 0.1,
        -np.abs(rng.standard_normal((di, N))),
        rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
        rng.standard_normal(di))]


@pytest.mark.parametrize("B,S,di,N", [(2, 64, 32, 8), (1, 100, 64, 16),
                                      (2, 256, 96, 16), (3, 33, 130, 4),
                                      (1, 70, 200, 32)])
def test_mamba_scan_one_launch_per_call(cuda, B, S, di, N):
    x, dt, A, Bs, Cs, D = (t.to(cuda) for t in _scan(B, S, di, N))
    with torch.inference_mode():
        before = ms.launches
        out, h = ops.selective_scan_fused(x, dt, A, Bs, Cs, D)
        assert ms.launches == before + 1
        want, h_want = ref.mamba_scan_ref(x, dt, A, Bs, Cs)
        want = want + x * D
    torch.cuda.synchronize()
    _close(out, want, 1e-4)
    _close(h, h_want, 1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
@pytest.mark.parametrize("S", [1, 31, 33, 2048])
def test_mamba_scan_state_in_and_out(cuda, S, N, with_h0):
    """h0 read and h_last written by the kernel, around its 32-step chunks
    (the last chunk's zero-filled steps must leave h as it is), at every
    state size and d_inner = 200: y and h_last against
    `ref.mamba_scan_ref(h0=...)` to the scan's 1e-4; a null h0 pointer
    gives, bit for bit, what zeros give."""
    x, dt, A, Bs, Cs, D = (t.to(cuda) for t in _scan(2, S, 200, N, seed=S))
    h0 = (torch.from_numpy(np.random.default_rng(N).standard_normal(
        (2, 200, N)).astype(np.float32)).to(cuda) if with_h0 else None)
    with torch.inference_mode():
        before = ms.launches
        y, h = ms.mamba_scan(x, dt, A, Bs, Cs, D=D, h0=h0)
        assert ms.launches == before + 1
        y_want, h_want = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
        y_want = y_want + x * D
        y0, h0_out = ms.mamba_scan(x, dt, A, Bs, Cs, D=D, h0=torch.zeros(
            (2, 200, N), device=cuda))
    torch.cuda.synchronize()
    _close(y, y_want, 1e-4)
    _close(h, h_want, 1e-4)
    if h0 is None:
        assert torch.equal(y, y0) and torch.equal(h, h0_out)


@pytest.mark.parametrize("B,with_D", [(1, False), (3, True)])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
@pytest.mark.parametrize("S", [1, 31, 33, 2048])
def test_mamba_scan_edges(cuda, S, N, B, with_D):
    """Time steps around the kernel's 32-step chunks, every state size,
    d_inner = 200 (not a multiple of the block's 32 channels), with and
    without the skip weights D."""
    x, dt, A, Bs, Cs, D = (t.to(cuda) for t in _scan(B, S, 200, N, seed=S))
    D = D if with_D else None
    with torch.inference_mode():
        before = ms.launches
        out, _ = ms.mamba_scan(x, dt, A, Bs, Cs, D=D)
        assert ms.launches == before + 1
        want = ref.mamba_scan_ref(x, dt, A, Bs, Cs)[0]
        if with_D:
            want = want + x * D
    torch.cuda.synchronize()
    _close(out, want, 1e-4)


def test_mamba_scan_sums_in_the_kernels_order(cuda):
    """The kernel against `ref.mamba_scan_lanes_ref` at its own order of
    sums (8 lanes at N = 16), the order the CPU tests hold to the Pallas
    kernel, to 1e-5 over 2048 steps of slow decay: the kernel rounds h as
    the plain version does, so its h does not drift."""
    x, dt, A, Bs, Cs, _ = (t.to(cuda) for t in _scan(1, 2048, 96, 16,
                                                       seed=2048))
    with torch.inference_mode():
        out, _ = ms.mamba_scan(x, dt, A, Bs, Cs)
        want = ref.mamba_scan_lanes_ref(x, dt, A, Bs, Cs, lanes=8)
    torch.cuda.synchronize()
    _close(out, want, 1e-5)


def _conv_params(F, H, seed=0):
    rng = np.random.default_rng(seed)
    p = {w: torch.from_numpy(rng.standard_normal((F, H)).astype(np.float32)
                             * 0.1) for w in ("wr", "wl", "wrt")}
    p["b"] = torch.from_numpy(rng.standard_normal(H).astype(np.float32) * .1)
    return p


@pytest.mark.parametrize("B,N,F,H", [(8, 48, 26, 96), (8, 64, 96, 96),
                                     (3, 16, 8, 12), (1, 64, 30, 64),
                                     (5, 33, 27, 40)])
def test_tree_conv_one_launch_per_call(cuda, B, N, F, H):
    feat, left, right, mask = (t.to(cuda) for t in _inputs(B, N, F))
    params = {w: t.to(cuda) for w, t in _conv_params(F, H).items()}
    with torch.inference_mode():
        before = tree_conv.tree_conv_launches
        out = ops.tree_conv_batch(feat, left, right, mask, params)
        assert tree_conv.tree_conv_launches == before + 1
        want = ref.tree_conv_batch_ref(feat, left, right, mask,
                                       params["wr"], params["wl"],
                                       params["wrt"], params["b"])
    torch.cuda.synchronize()
    _close(out, want, 1e-5)
    assert not out[-1].any()                   # an all-masked tree


@pytest.mark.parametrize("N", [1, 17, 48, 64])
@pytest.mark.parametrize("H", [1, 32, 96, 128])
@pytest.mark.parametrize("F", [1, 26, 96, 512])
def test_tree_conv_edges(cuda, F, H, N):
    """Input widths from 1 to the kernel's 512 (two weight tiles), output
    widths around its 32-channel blocks, node counts around its 16-node
    blocks; children outside [0, N) and an all-masked tree."""
    feat, left, right, mask = (t.to(cuda) for t in _inputs(3, N, F, seed=F))
    p = {w: t.to(cuda) for w, t in _conv_params(F, H, seed=H).items()}
    with torch.inference_mode():
        before = tree_conv.tree_conv_launches
        out = tree_conv.tree_conv(feat, left, right, mask, p["wr"], p["wl"],
                                  p["wrt"], p["b"])
        assert tree_conv.tree_conv_launches == before + 1
        want = ref.tree_conv_batch_ref(feat, left, right, mask, p["wr"],
                                       p["wl"], p["wrt"], p["b"])
    torch.cuda.synchronize()
    _close(out, want, 1e-5)
    assert not out[-1].any()


def test_tree_conv_unaligned_rows(cuda):
    """Inputs and weights that start 4 bytes past a 16-byte boundary take
    the kernel's narrower copies."""
    feat, left, right, mask = (t.to(cuda) for t in _inputs(4, 48, 96))
    p = {w: t.to(cuda) for w, t in _conv_params(96, 96).items()}

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    feat, p = shifted(feat), {w: shifted(t) for w, t in p.items()}
    with torch.inference_mode():
        out = tree_conv.tree_conv(feat, left, right, mask, p["wr"], p["wl"],
                                  p["wrt"], p["b"])
        want = ref.tree_conv_batch_ref(feat, left, right, mask, p["wr"],
                                       p["wl"], p["wrt"], p["b"])
    torch.cuda.synchronize()
    _close(out, want, 1e-5)


def test_ops_never_reach_a_plain_version_on_the_card(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")
    for name in ("flash_attention_ref", "mamba_scan_ref",
                 "tree_conv_batch_ref"):
        monkeypatch.setattr(ref, name, refuse)
    with torch.inference_mode():
        q, k, v = (t.to(cuda) for t in _attn(1, 64, 64, 4, 2, 64,
                                               torch.bfloat16))
        ops.mha_flash(q, k, v)
        x, dt, A, Bs, Cs, D = (t.to(cuda) for t in _scan(1, 40, 64, 16))
        ops.selective_scan_fused(x, dt, A, Bs, Cs, D)
        feat, left, right, mask = (t.to(cuda) for t in _inputs(2, 16, 8))
        ops.tree_conv_batch(feat, left, right, mask,
                            {w: t.to(cuda)
                             for w, t in _conv_params(8, 12).items()})
    torch.cuda.synchronize()


def test_ops_kernels_reject_mixed_devices(cuda):
    q, k, v = _attn(1, 64, 64, 4, 2, 64, torch.float32)
    x, dt, A, Bs, Cs, _ = _scan(1, 40, 64, 16)
    feat, left, right, mask = _inputs(2, 16, 8)
    p = _conv_params(8, 12)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="is on"):
            ops.mha_flash(q.to(cuda), k, v.to(cuda))
        with pytest.raises(ValueError, match="is on"):
            ms.mamba_scan(x.to(cuda), dt.to(cuda), A, Bs.to(cuda),
                          Cs.to(cuda))
        with pytest.raises(ValueError, match="is on"):
            tree_conv.tree_conv(feat.to(cuda), left.to(cuda),
                                right.to(cuda), mask.to(cuda), p["wr"],
                                p["wl"].to(cuda), p["wrt"].to(cuda),
                                p["b"].to(cuda))


def test_ops_kernels_reject_wrong_dtypes_on_card(cuda):
    q, k, v = (t.to(cuda) for t in _attn(1, 64, 64, 4, 2, 64,
                                           torch.float32))
    x, dt, A, Bs, Cs, _ = (t.to(cuda) for t in _scan(1, 40, 64, 16))
    feat, left, right, mask = (t.to(cuda) for t in _inputs(2, 16, 8))
    p = {w: t.to(cuda) for w, t in _conv_params(8, 12).items()}
    with torch.inference_mode():
        with pytest.raises(TypeError):
            ops.mha_flash(q.half(), k.half(), v.half())
        with pytest.raises(TypeError):
            ops.mha_flash(q, k.bfloat16(), v)
        with pytest.raises(TypeError):
            ms.mamba_scan(x.double(), dt, A, Bs, Cs)
        with pytest.raises(TypeError):
            tree_conv.tree_conv(feat, left.long(), right, mask, p["wr"],
                                p["wl"], p["wrt"], p["b"])


def test_ops_kernels_reject_unsupported_widths_on_card(cuda):
    q, k, v = (t.to(cuda) for t in _attn(1, 64, 64, 4, 2, 48,
                                           torch.bfloat16))
    x, dt, A, Bs, Cs, _ = (t.to(cuda) for t in _scan(1, 40, 64, 12))
    feat, left, right, mask = (t.to(cuda) for t in _inputs(2, 65, 8))
    p = {w: t.to(cuda) for w, t in _conv_params(8, 12).items()}
    with torch.inference_mode():
        with pytest.raises(ValueError, match="hd"):
            ops.mha_flash(q, k, v)
        with pytest.raises(ValueError, match="N in"):
            ms.mamba_scan(x, dt, A, Bs, Cs)
        with pytest.raises(ValueError, match="N <= 64"):
            tree_conv.tree_conv(feat, left, right, mask, p["wr"], p["wl"],
                                p["wrt"], p["b"])
    # the old guard against autograd is gone: a call that needs a
    # gradient goes through the kernel's autograd Function
    qg = torch.zeros((4, 64, 32), device=cuda, requires_grad=True)
    kv = torch.zeros((2, 64, 32), device=cuda)
    out = fa.flash_attention(qg, kv, kv)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    xg = x.clone().requires_grad_(True)
    A16 = -torch.ones((64, 16), device=cuda)
    y, _ = ms.mamba_scan(xg, dt, A16, Bs[..., :1].expand(-1, -1, 16)
                         .contiguous(), Cs[..., :1].expand(-1, -1, 16)
                         .contiguous())
    assert type(y.grad_fn).__name__ == "MambaScanBackward"


# --------------------------------------- the kernels' autograd Functions
# The Functions' backward is the plain version's autograd on the saved
# inputs, so their input gradients equal plain autograd's on the same
# inputs and cotangent up to GRAD_RTOL of each gradient's largest |value|
# (the same ops; a cuBLAS product may take another algorithm). Forward
# outputs at the one-launch tests' limits.
GRAD_RTOL = 1e-6


def _grads_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= \
            GRAD_RTOL * float(w.float().abs().max())


@pytest.mark.parametrize("B,S,H,K,hd,window,cap,dtype", [
    (1, 1024, 32, 8, 128, 0, 0.0, torch.bfloat16),   # qwen3-8b's layer
    (1, 512, 32, 8, 128, 0, 0.0, torch.float32),
    (1, 512, 16, 8, 128, 256, 50.0, torch.bfloat16),  # gemma2's local layer
    (2, 300, 4, 2, 64, 0, 0.0, torch.bfloat16),       # ragged tiles
])
def test_flash_attention_function_gradients(cuda, B, S, H, K, hd, window,
                                            cap, dtype):
    """mha_flash with gradients on: one kernel launch in the forward and
    none in the backward; the output within the plain version's limits;
    dq, dk and dv equal to autograd through the plain version on the same
    inputs and cotangent."""
    q, k, v = (t.to(cuda).requires_grad_(True)
               for t in _attn(B, S, S, H, K, hd, dtype, seed=S + H))
    w = torch.randn((B, S, H, hd), device=cuda, generator=torch.Generator(
        cuda).manual_seed(0))
    kw = dict(causal=True, window=window, softcap=cap)
    before = fa.launches
    out = ops.mha_flash(q, k, v, **kw)
    assert fa.launches == before + 1
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert fa.launches == before + 1                     # backward: plain
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, S, hd) for t in (q, k, v))
    want_out = ref.flash_attention_ref(qf, kf, vf, **kw)
    want = torch.autograd.grad(
        (want_out.float() * w.transpose(1, 2).reshape(-1, S, hd)).sum(),
        (q, k, v))
    want_out = want_out.reshape(B, H, S, hd).transpose(1, 2)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _close(out.detach(), want_out.detach(), 2e-5)
    else:
        _close(out.detach(), want_out.detach(), BF16_ATOL, BF16_RTOL)
    _grads_close(got, want)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,di,N", [(2, 256, 512, 16), (1, 33, 130, 4)])
def test_mamba_scan_function_gradients(cuda, B, S, di, N, with_h0):
    """selective_scan_fused with gradients on, with D and, if asked, h0:
    one launch in the forward and none in the backward; y and h_last
    within 1e-4; the gradients of x, dt, A, Bs, Cs, D and h0 (through
    both outputs) equal to autograd through the plain version."""
    x, dt, A, Bs, Cs, D = (t.to(cuda) for t in _scan(B, S, di, N, seed=S))
    h0 = torch.randn((B, di, N), device=cuda, generator=torch.Generator(
        cuda).manual_seed(1)) if with_h0 else None
    ins = [t.requires_grad_(True) for t in (x, dt, A, Bs, Cs, D)
           + ((h0,) if with_h0 else ())]
    gen = torch.Generator(cuda).manual_seed(2)
    wy = torch.randn((B, S, di), device=cuda, generator=gen)
    wh = torch.randn((B, di, N), device=cuda, generator=gen)
    before = ms.launches
    y, h = ops.selective_scan_fused(*ins[:6], h0=h0)
    assert ms.launches == before + 1
    got = torch.autograd.grad((y * wy).sum() + (h * wh).sum(), ins)
    assert ms.launches == before + 1
    y_want, h_want = ref.mamba_scan_ref(*ins[:5], h0)
    y_want = y_want + ins[0] * ins[5]
    want = torch.autograd.grad((y_want * wy).sum() + (h_want * wh).sum(),
                               ins)
    torch.cuda.synchronize()
    _close(y.detach(), y_want.detach(), 1e-4)
    _close(h.detach(), h_want.detach(), 1e-4)
    _grads_close(got, want)
    assert all(g.abs().max() > 0 for g in got)


def test_functions_keep_the_inference_path(cuda):
    """Without gradients the wrappers launch their kernels as before: no
    autograd node, one launch a call."""
    q, k, v = (t.to(cuda).requires_grad_(True)
               for t in _attn(1, 64, 64, 4, 2, 64, torch.bfloat16))
    before = fa.launches
    with torch.no_grad():
        out = ops.mha_flash(q, k, v)
    assert out.grad_fn is None and fa.launches == before + 1


# ------------------------------------------------------- the LM serving path
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402


def _kernel_layers(cfg):
    """(attention layers on the kernel's route, Mamba layers) of a stack."""
    attn = sum(s.mixer != "mamba" and cfg.mla is None
               and attention.kernel_route(attention.MIXER_KIND[s.mixer],
                                          cfg.hd, cfg.hd)
               for s in cfg.block_pattern) * cfg.n_superblocks
    mamba = sum(s.mixer == "mamba" for s in cfg.block_pattern) \
        * cfg.n_superblocks
    return attn, mamba


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b",
                                  "gemma2-27b", "whisper-tiny",
                                  "jamba-1.5-large-398b"])
def test_lm_serves_through_the_kernels(cuda, arch, dtype, tol,
                                      monkeypatch):
    """A reduced arch's `generate` on the card launches flash_attention
    once a kernel-route attention layer a step (and once an encoder
    layer) and mamba_scan once a Mamba layer at the prefill; its prefill
    and 3 decode steps (fed the CPU's greedy tokens) agree with the CPU's
    plain versions within `tol` of the largest |logit| (1e-4 in fp32; in
    bf16 3e-2, the dense archs' limit in tests/torch_lm_cases.py). An MoE
    layer on the card takes the experts the CPU chose, with the card's own
    gates: a token near a tie of router probabilities would otherwise go
    to another expert where bf16 rounds the other way."""
    cfg = dataclasses.replace(registry.reduced(registry.get_config(arch)),
                              compute_dtype=dtype)
    route, routes = moe.route, []

    def record(probs, K):
        gate, eidx = route(probs, K)
        routes.append(eidx)
        return gate, eidx

    def impose(probs, K):
        eidx = routes.pop(0).to(probs.device)
        gate = probs.gather(-1, eidx)
        return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 16)).astype(np.int32)
    attn, mamba = _kernel_layers(cfg)
    enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    card = BatchedServer(cfg, params=params, device=cuda)
    fa_before, ms_before = fa.launches, ms.launches
    card.generate(prompts, 6)
    torch.cuda.synchronize()
    assert fa.launches - fa_before == attn * (1 + 6) + enc
    assert ms.launches - ms_before == mamba
    logits = {}
    for dev, server in (("cpu", BatchedServer(cfg, params=params,
                                              device="cpu")), ("cuda", card)):
        toks = torch.as_tensor(prompts.astype(np.int64), device=dev)
        memory = None
        if cfg.encoder is not None:
            memory = lm.encode(server.serving, torch.zeros(
                (2, cfg.encoder.n_frames, cfg.d_model), device=dev), cfg)
        if cfg.family == "vlm":
            memory = torch.zeros((2, cfg.vision_tokens, cfg.d_model),
                                 dtype=cfg.cdtype, device=dev)
        monkeypatch.setattr(moe, "route", record if dev == "cpu" else impose)
        with torch.inference_mode():
            out, cache = lm.prefill(server.serving, toks, cfg, 16 + 3,
                                    memory=memory)
            steps = [out.float().cpu()]
            for s in range(3):
                tok = (logits["cpu"][s] if dev == "cuda" else steps[-1]) \
                    .argmax(-1)[:, None].to(dev)
                out, cache = lm.decode_step(server.serving, tok, cache, cfg,
                                            16 + s)
                steps.append(out.float().cpu())
        logits[dev] = steps
        if dev == "cpu":
            assert bool(routes) == (cfg.moe is not None)
    assert not routes
    scale = max(float(t.abs().max()) for t in logits["cpu"])
    for want, got in zip(logits["cpu"], logits["cuda"]):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= tol * scale


# ------------------------------------------------------- the LM training path
@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b",
                                  "gemma2-27b", "whisper-tiny"])
def test_lm_trains_through_the_kernels(cuda, arch):
    """A reduced arch's loss and gradients (`launch.steps.loss_and_grads`,
    remat on, fp32 compute) on the card: each kernel-route attention
    layer and Mamba layer launches its kernel twice (the forward and the
    remat re-forward; the backward recomputes the plain version), and
    the loss and every gradient leaf agree with the CPU's plain versions
    (loss to 1e-5, each leaf to 1e-4 of its largest |value|, as the CPU
    tests hold the port to the reference). Then three train steps on the
    card lower the loss of a repeated batch."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import batch_on, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten, tree_map
    cfg = dataclasses.replace(registry.reduced(registry.get_config(arch)),
                              compute_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (2, 32)).astype(np.int32)
    attn, mamba = _kernel_layers(cfg)
    enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = batch_on({"tokens": toks}, cfg, dev)
        fa_before, ms_before = fa.launches, ms.launches
        (loss, _), grads = loss_and_grads(p, batch, cfg)
        out[dev] = (float(loss), {k: g.cpu() for k, g in flatten(grads)})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fa.launches - fa_before == 2 * (attn + enc)
            assert ms.launches - ms_before == 2 * mamba
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for path, want in gc.items():
        assert float((gg[path].float() - want.float()).abs().max()) <= \
            1e-4 * float(want.float().abs().max()), path
    p = tree_map(lambda t: t.to(cuda), params)
    opt = adamw_init(p)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), 3)
    batch = batch_on({"tokens": toks}, cfg, cuda)
    losses = [float(step(p, opt, 0, batch)[3]["loss"]) for _ in range(3)]
    assert losses[-1] < losses[0]


from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.sharding import act  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b",
                                  "dbrx-132b", "minicpm3-4b"])
def test_counted_step_on_card_equals_meta(cuda, arch):
    """A reduced train step counted by `launch.opanalysis` on the card
    equals its count on `meta` (FLOPs, bytes, the kernels' records), and
    each kernel record is a launch."""
    cfg = registry.reduced(registry.get_config(arch))
    shape = ShapeConfig("train_small", 32, 2, "train")
    meta, _, _ = dryrun.count_step(cfg, shape)
    params = lm.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                            device=cuda)
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32, device=cuda)}
    fa0, ms0 = fa.launches, ms.launches
    card, _, _ = dryrun.count_step(cfg, shape, inputs=(params, opt, batch))
    torch.cuda.synchronize()
    assert (card.flops, card.bytes) == (meta.flops, meta.bytes)
    calls = card.kernel_totals()
    assert calls == meta.kernel_totals()
    assert fa.launches - fa0 == calls.get("flash_attention",
                                          {"calls": 0})["calls"]
    assert ms.launches - ms0 == calls.get("mamba_scan", {"calls": 0})["calls"]


def test_remat_modes_on_the_card(cuda):
    """remat "full", "dots" and "none" give one loss and one set of
    gradients on the card (the same ops; "dots" keeps the matmuls'
    outputs), launching the attention kernel twice, twice and once a
    layer."""
    cfg = registry.reduced(registry.get_config("qwen3-8b"))
    params = lm.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                            device=cuda)
    toks = torch.randint(2, cfg.vocab_size, (2, 32), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    layers = cfg.n_layers
    out = {}
    for mode, per_layer in (("full", 2), ("dots", 2), ("none", 1)):
        before = fa.launches
        with act.policy(act.ActivationPolicy(remat=mode)):
            (loss, _), grads = loss_and_grads(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        assert fa.launches - before == per_layer * layers, mode
        out[mode] = (float(loss), flatten(grads))
    for mode in ("dots", "none"):
        assert out[mode][0] == out["full"][0], mode
        for (path, a), (_, b) in zip(out["full"][1], out[mode][1]):
            assert float((a - b).abs().max()) <= \
                1e-5 * float(a.abs().max()), (mode, path)
