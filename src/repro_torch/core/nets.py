"""Decision-model networks: the TreeCNN (default), LSTM, FCNN and
QueryFormer-lite encoders of the paper's Tab. III / Fig. 11(b) ablation,
and the MLP head.

Weights keep the reference's `(d_in, d_out)` layout and are applied as
`x @ W` (not `nn.Linear`'s transposed layout), so a reference parameter
tree copies across leaf for leaf: `enc.conv1.wr` is `enc/conv1/wr`, and
the QueryFormer's `enc.layers.0.wq` is the reference's list entry
`enc/layers/0/wq`. Each module draws its weights on the host from a
uint32[2] PRNG key, as the reference's `init_encoder` and `init_mlp_head`
do: the same splits, `prng.normal` for `jax.random.normal`, and the
scale applied as one fp32 multiply, so a key gives the reference's
weights bit for bit.

Every encoder maps a batch (B, N, F) to (B, H) and a single state
(N, F) to (H,) as a batch of one. The TreeCNN always goes through
`kernels.tree_conv.tree_cnn_fused`, a CUDA kernel for CUDA tensors and
its plain version for CPU tensors. The other three are plain tensor ops
in the reference (jnp, no Pallas) and in the port:

  * LSTM: a Python loop over the node slots in pre-order (the padded
    order), batched over B, with the reference's gate order (i, f, g, o),
    forget bias +1 and masked carry, so a masked slot keeps the state;
  * FCNN: two leaky_relu layers over `feat * mask` flattened node-major
    over all MAX_NODES slots (it is never trimmed);
  * QueryFormer-lite: self-attention over the node tokens with a
    structural bias (0 on tree edges and the diagonal, -4 elsewhere) and
    -1e9 on padded keys, a residual and a re-mask per layer, then a
    masked max-pool. `torch.amax` splits the gradient evenly among tied
    maxima, as `jnp.max` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.core.encoding import MAX_NODES
from repro_torch.kernels.tree_conv import LAYERS, tree_cnn_fused


def _normal(key, shape, scale: float) -> nn.Parameter:
    """`normal_init(key, shape, float32, scale)` of the reference."""
    return nn.Parameter(torch.from_numpy(np.float32(scale)
                                         * prng.normal(key, shape)))


class _Encoder(nn.Module):
    """(B, N, F) -> (B, H) through `encode`; (N, F) -> (H,) as a batch of
    one."""

    def forward(self, feat, left, right, mask):
        if feat.dim() == 2:
            return self.encode(feat[None], left[None], right[None],
                               mask[None])[0]
        return self.encode(feat, left, right, mask)


def _masked_max_pool(h, mask):
    """Max over the real nodes; 0 for a tree without one."""
    pooled = torch.amax(torch.where(mask[..., None] > 0, h, -torch.inf),
                        dim=1)
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


class TreeConv(nn.Module):
    """Weights of one Neo tree-conv layer (applied inside the fused
    encoder): `leaky_relu(h@wr + h[left]@wl + h[right]@wrt + b) * mask`."""

    def __init__(self, d_in: int, d_out: int, key):
        super().__init__()
        k = prng.split(key, 4)
        s = 1.0 / (3 * d_in) ** 0.5
        self.wr = _normal(k[0], (d_in, d_out), s)
        self.wl = _normal(k[1], (d_in, d_out), s)
        self.wrt = _normal(k[2], (d_in, d_out), s)
        self.b = nn.Parameter(torch.zeros(d_out))


class TreeCNN(_Encoder):
    """Three tree-conv layers, a residual on the third and a masked
    max-pool over the nodes, as one fused kernel."""

    def __init__(self, feat_dim: int, hidden: int, key):
        super().__init__()
        k = prng.split(key, 3)
        self.conv1 = TreeConv(feat_dim, hidden, k[0])
        self.conv2 = TreeConv(hidden, hidden, k[1])
        self.conv3 = TreeConv(hidden, hidden, k[2])

    def params(self):
        """The reference's nested parameter dict, as the kernel takes it."""
        return {name: {"wr": conv.wr, "wl": conv.wl, "wrt": conv.wrt,
                       "b": conv.b}
                for name, conv in ((n, getattr(self, n)) for n in LAYERS)}

    def encode(self, feat, left, right, mask):
        return tree_cnn_fused(feat, left, right, mask, self.params())


class LSTM(_Encoder):
    """The node sequence in pre-order -> the last hidden state."""

    def __init__(self, feat_dim: int, hidden: int, key):
        super().__init__()
        k = prng.split(key, 2)
        s = 1.0 / (feat_dim + hidden) ** 0.5
        self.wx = _normal(k[0], (feat_dim, 4 * hidden), s)
        self.wh = _normal(k[1], (hidden, 4 * hidden), s)
        self.b = nn.Parameter(torch.zeros(4 * hidden))

    def encode(self, feat, left, right, mask):
        B, N, _ = feat.shape
        H = self.wh.shape[0]
        h = feat.new_zeros((B, H))
        c = feat.new_zeros((B, H))
        xw = feat @ self.wx                   # every step's x @ wx at once
        for t in range(N):
            z = xw[:, t] + h @ self.wh + self.b
            i, f, g, o = z.split(H, dim=-1)
            c_new = torch.sigmoid(f + 1.0) * c + \
                torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = mask[:, t, None]
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
        return h


class FCNN(_Encoder):
    """Two leaky_relu layers over the masked features of all
    `max_nodes` slots, flattened node-major."""

    def __init__(self, feat_dim: int, hidden: int, key,
                 max_nodes: int = MAX_NODES):
        super().__init__()
        k = prng.split(key, 2)
        d = feat_dim * max_nodes
        self.w1 = _normal(k[0], (d, hidden), d ** -0.5)
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = _normal(k[1], (hidden, hidden), hidden ** -0.5)
        self.b2 = nn.Parameter(torch.zeros(hidden))

    def encode(self, feat, left, right, mask):
        x = (feat * mask[..., None]).reshape(feat.shape[0], -1)
        h = F.leaky_relu(x @ self.w1 + self.b1, 0.01)
        return F.leaky_relu(h @ self.w2 + self.b2, 0.01)


class _QFLayer(nn.Module):
    def __init__(self, hidden: int, keys):
        super().__init__()
        s = hidden ** -0.5
        self.wq = _normal(keys[0], (hidden, hidden), s)
        self.wk = _normal(keys[1], (hidden, hidden), s)
        self.wv = _normal(keys[2], (hidden, hidden), s)
        self.wo = _normal(keys[3], (hidden, hidden), s)


class QueryFormer(_Encoder):
    """Self-attention over node tokens with a tree-structure bias,
    QueryFormer-style but miniature: single-headed (the reference's
    `n_heads` argument is never read)."""

    def __init__(self, feat_dim: int, hidden: int, key, n_layers: int = 2):
        super().__init__()
        ks = prng.split(key, 2 + 4 * n_layers)    # ks[1] is never used
        self.inp = _normal(ks[0], (feat_dim, hidden), feat_dim ** -0.5)
        self.layers = nn.ModuleList(
            _QFLayer(hidden, ks[2 + 4 * i:6 + 4 * i])
            for i in range(n_layers))

    def encode(self, feat, left, right, mask):
        h = (feat * mask[..., None]) @ self.inp
        B, N, _ = feat.shape
        adj = feat.new_zeros((B, N, N))
        adj.scatter_(2, left.long()[..., None], 1.0)
        adj.scatter_(2, right.long()[..., None], 1.0)
        adj = adj + adj.transpose(1, 2) + torch.eye(N, device=feat.device)
        bias = torch.where(adj > 0, 0.0, -4.0)    # soft structural prior
        key_mask = torch.where(mask > 0, 0.0, -1e9)
        scale = h.shape[-1] ** 0.5
        for lp in self.layers:
            q, k, v = h @ lp.wq, h @ lp.wk, h @ lp.wv
            s = q @ k.transpose(1, 2) / scale + bias + key_mask[:, None, :]
            a = torch.softmax(s, dim=-1)
            h = h + (a @ v) @ lp.wo
            h = h * mask[..., None]
        return _masked_max_pool(h, mask)


def make_encoder(kind: str, feat_dim: int, hidden: int, key,
                 max_nodes: int = MAX_NODES) -> _Encoder:
    """The reference's `init_encoder(key, kind, feat_dim, hidden,
    max_nodes)` as a module."""
    if kind == "treecnn":
        return TreeCNN(feat_dim, hidden, key)
    if kind == "lstm":
        return LSTM(feat_dim, hidden, key)
    if kind == "fcnn":
        return FCNN(feat_dim, hidden, key, max_nodes)
    if kind == "queryformer":
        return QueryFormer(feat_dim, hidden, key)
    raise ValueError(kind)


class MLPHead(nn.Module):
    """`leaky_relu(x @ w1 + b1) @ w2 + b2`."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, key):
        super().__init__()
        k = prng.split(key, 2)
        self.w1 = _normal(k[0], (d_in, d_hidden), d_in ** -0.5)
        self.b1 = nn.Parameter(torch.zeros(d_hidden))
        self.w2 = _normal(k[1], (d_hidden, d_out), d_hidden ** -0.5)
        self.b2 = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return F.leaky_relu(x @ self.w1 + self.b1, 0.01) @ self.w2 + self.b2


class EncoderHead(nn.Module):
    """One actor or critic network: an encoder of kind `net`, then the MLP
    head, initialised from one key each."""

    def __init__(self, feat_dim: int, hidden: int, head_hidden: int,
                 d_out: int, enc_key, head_key, net: str = "treecnn"):
        super().__init__()
        self.enc = make_encoder(net, feat_dim, hidden, enc_key)
        self.head = MLPHead(hidden, head_hidden, d_out, head_key)

    def forward(self, feat, left, right, mask):
        return self.head(self.enc(feat, left, right, mask))
