"""Decision-model networks: the TreeCNN encoder and the MLP head.

Weights keep the reference's `(d_in, d_out)` layout and are applied as
`x @ W` (not `nn.Linear`'s transposed layout), so a reference parameter
tree copies across leaf for leaf: `enc.conv1.wr` is `enc/conv1/wr`.
The encoder always goes through `kernels.tree_conv.tree_cnn_fused`, a
CUDA kernel for CUDA tensors and its plain version for CPU tensors; a
single state (N, F) is a batch of one. The LSTM, FCNN and QueryFormer
encoders of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.tree_conv import LAYERS, tree_cnn_fused


def _normal(shape, scale: float, generator: Optional[torch.Generator]):
    return nn.Parameter(torch.randn(shape, generator=generator) * scale)


class TreeConv(nn.Module):
    """Weights of one Neo tree-conv layer (applied inside the fused
    encoder): `leaky_relu(h@wr + h[left]@wl + h[right]@wrt + b) * mask`."""

    def __init__(self, d_in: int, d_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s = 1.0 / (3 * d_in) ** 0.5
        self.wr = _normal((d_in, d_out), s, generator)
        self.wl = _normal((d_in, d_out), s, generator)
        self.wrt = _normal((d_in, d_out), s, generator)
        self.b = nn.Parameter(torch.zeros(d_out))


class TreeCNN(nn.Module):
    """Three tree-conv layers, a residual on the third and a masked
    max-pool over the nodes: (B, N, F) -> (B, H), or (N, F) -> (H,)."""

    def __init__(self, feat_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = TreeConv(feat_dim, hidden, generator)
        self.conv2 = TreeConv(hidden, hidden, generator)
        self.conv3 = TreeConv(hidden, hidden, generator)

    def params(self):
        """The reference's nested parameter dict, as the kernel takes it."""
        return {name: {"wr": conv.wr, "wl": conv.wl, "wrt": conv.wrt,
                       "b": conv.b}
                for name, conv in ((n, getattr(self, n)) for n in LAYERS)}

    def forward(self, feat, left, right, mask):
        if feat.dim() == 2:
            return self.forward(feat[None], left[None], right[None],
                                mask[None])[0]
        return tree_cnn_fused(feat, left, right, mask, self.params())


class MLPHead(nn.Module):
    """`leaky_relu(x @ w1 + b1) @ w2 + b2`."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = _normal((d_in, d_hidden), d_in ** -0.5, generator)
        self.b1 = nn.Parameter(torch.zeros(d_hidden))
        self.w2 = _normal((d_hidden, d_out), d_hidden ** -0.5, generator)
        self.b2 = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return F.leaky_relu(x @ self.w1 + self.b1, 0.01) @ self.w2 + self.b2


class EncoderHead(nn.Module):
    """One actor or critic network: TreeCNN encoder, then MLP head."""

    def __init__(self, feat_dim: int, hidden: int, head_hidden: int,
                 d_out: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc = TreeCNN(feat_dim, hidden, generator)
        self.head = MLPHead(hidden, head_hidden, d_out, generator)

    def forward(self, feat, left, right, mask):
        return self.head(self.enc(feat, left, right, mask))
