"""Launch hygiene of the port's CUDA kernels, on the card only.

Run there with `python -m pytest -q -m gpu tests/test_torch_kernel_launch.py`;
elsewhere every test skips. This file imports no jax: the machine with the
card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.agent import AgentConfig, AqoraAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta  # noqa: E402
from repro_torch.core.nets import TreeCNN  # noqa: E402
from repro_torch.kernels import tree_conv  # noqa: E402

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
    enc = TreeCNN(26, 96, torch.Generator().manual_seed(0)).to(cuda)
    feat, left, right, mask = _inputs()
    with pytest.raises(ValueError, match="is on"):
        tree_conv.tree_cnn_fused(feat.to(cuda), left, right.to(cuda),
                                 mask.to(cuda), enc.params())
    with torch.inference_mode(), pytest.raises(ValueError, match="is on"):
        tree_conv.tree_cnn_fused(feat, left, right, mask, enc.params())


def test_wrong_dtype_or_layout_raises_on_card(cuda):
    enc = TreeCNN(26, 96, torch.Generator().manual_seed(0)).to(cuda)
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
    enc = TreeCNN(F, H, torch.Generator().manual_seed(1)).to(cuda)
    feat, left, right, mask = (t.to(cuda) for t in _inputs(B, N, F))
    with torch.inference_mode():
        before = tree_conv.launches
        out = enc(feat, left, right, mask)
        assert tree_conv.launches == before + 1
        single = enc(feat[0], left[0], right[0], mask[0])
        assert tree_conv.launches == before + 2
        ref = tree_conv.tree_cnn_fused_ref(feat, left, right, mask,
                                           enc.params())
    torch.cuda.synchronize()
    assert out.device.type == "cuda"
    assert float((out - ref).abs().max()) <= 1e-4
    assert float((single - ref[0]).abs().max()) <= 1e-4
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
    before = tree_conv.launches
    a, logp, _ = agent.act_batch(feat, left, right, mask, amask, keys,
                                 explore=False)
    assert tree_conv.launches == before + 1
    assert a.shape == (8,) and np.isfinite(logp).all()
