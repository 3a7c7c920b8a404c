"""The port's fused TreeCNN against the reference's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
to `repro.kernels.tree_conv.tree_cnn_fused` in interpret mode at the
reference's own shapes and tolerance (tests/test_vec_rollout.py), plus
the serving shape, with all-masked lanes and child indices outside
[0, N) (the one-hot form reads those as zero rows). The CUDA kernel
itself is checked on the card (test_torch_kernel_launch.py and
chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nets as jnets  # noqa: E402
from repro.kernels.tree_conv import tree_cnn_fused as jax_tree_cnn_fused  # noqa: E402
from repro_torch.kernels import tree_conv  # noqa: E402


def _case(B, N, F, H, seed):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, N, F)).astype(np.float32)
    feat[:, 0] = 0.0                                   # null slot
    left = rng.integers(0, N, (B, N)).astype(np.int32)
    right = rng.integers(0, N, (B, N)).astype(np.int32)
    left[:, 1::5] = N + 2                              # past the end
    right[:, 3::4] = -1                                # negative
    mask = (rng.random((B, N)) > 0.3).astype(np.float32)
    mask[:, 0] = 0.0
    mask[-1] = 0.0                                     # an all-masked lane
    params = jax.tree_util.tree_map(
        np.asarray, jnets._init_treecnn(jax.random.PRNGKey(seed), F, H))
    params["conv2"]["b"] = rng.standard_normal(H).astype(np.float32)
    return feat, left, right, mask, params


def _torch_params(params):
    return {k: {w: torch.from_numpy(np.array(v)) for w, v in p.items()}
            for k, p in params.items()}


@pytest.mark.parametrize("B,N,F,H,tile", [(5, 64, 27, 96, 2),
                                          (8, 16, 8, 32, 8),
                                          (3, 32, 12, 48, 4),
                                          (8, 48, 26, 96, 8)])
def test_plain_version_matches_pallas_kernel(B, N, F, H, tile):
    feat, left, right, mask, params = _case(B, N, F, H, seed=B * N + F)
    ref = jax_tree_cnn_fused(jnp.asarray(feat), jnp.asarray(left),
                             jnp.asarray(right), jnp.asarray(mask),
                             jax.tree_util.tree_map(jnp.asarray, params),
                             tile=tile, interpret=True)
    before = tree_conv.launches
    out = tree_conv.tree_cnn_fused(
        torch.from_numpy(feat), torch.from_numpy(left),
        torch.from_numpy(right), torch.from_numpy(mask),
        _torch_params(params))
    assert tree_conv.launches == before        # CPU tensors launch nothing
    assert out.shape == (B, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    assert not out[-1].any()                   # all-masked lane pools to 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    feat, left, right, mask, params = _case(2, 16, 6, 8, seed=3)
    t = [torch.from_numpy(x) for x in (feat, left, right, mask)]
    p = _torch_params(params)
    f = tree_conv.tree_cnn_fused
    with pytest.raises(TypeError):
        f(t[0], t[1].long(), t[2], t[3], p)
    with pytest.raises(TypeError):
        f(t[0].double(), t[1], t[2], t[3], p)
    with pytest.raises(ValueError, match="contiguous"):
        f(t[0].transpose(0, 1).contiguous().transpose(0, 1), t[1], t[2],
          t[3], p)
    with pytest.raises(ValueError, match="shape"):
        f(t[0], t[1][:, :8], t[2], t[3], p)
    bad = {k: dict(v) for k, v in p.items()}
    bad["conv2"]["wl"] = bad["conv2"]["wl"][:4]
    with pytest.raises(ValueError, match="shape"):
        f(*t, bad)
    wide = [torch.zeros((1, 65) + x.shape[2:], dtype=x.dtype) for x in t]
    with pytest.raises(ValueError, match="N <= 64"):
        f(*wide, p)


def test_reference_paths_disagree_on_out_of_range_children():
    """The reference's jnp encoder gathers with `h[idx]`, which clamps an
    index past the end and wraps a negative one; its Pallas kernel's
    one-hot reads both as a zero row. The port follows the kernel."""
    B, N, F, H = 3, 16, 6, 8
    feat, left, right, mask, params = _case(B, N, F, H, seed=11)
    mask[:] = 1.0
    mask[:, 0] = 0.0
    args = [jnp.asarray(x) for x in (feat, left, right, mask)]
    pallas = np.asarray(jax_tree_cnn_fused(
        *args, jax.tree_util.tree_map(jnp.asarray, params), interpret=True))
    jnp_path = np.asarray(jnets.apply_encoder(params, "treecnn", *args))
    port = tree_conv.tree_cnn_fused(
        torch.from_numpy(feat), torch.from_numpy(left),
        torch.from_numpy(right), torch.from_numpy(mask),
        _torch_params(params)).numpy()
    np.testing.assert_allclose(port, pallas, atol=1e-4, rtol=1e-4)
    assert np.abs(jnp_path - pallas).max() > 1e-3
