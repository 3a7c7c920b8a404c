"""int8 gradient compression with error feedback, as the reference's
`repro/optim/compress.py`: per-tensor symmetric int8, and the
quantization residual carried to the next step so that the noise is a
moving average, not a bias (Seide et al.).

`torch.round` rounds half to even, as `jnp.round` does. Divisions divide
by tensors (a CUDA tensor divided by a Python number is multiplied by its
reciprocal, which rounds otherwise). The reference's `compressed_psum`,
an explicit compressed all-reduce inside `shard_map`, comes with the
port's sharding tooling.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / torch.tensor(127.0, dtype=amax.dtype, device=amax.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, error_state=None):
    """Quantize every gradient leaf with error feedback.
    Returns (dequantized_grads, new_error_state)."""
    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)

    def one(g, e):
        g32 = g.to(torch.float32) + e
        dq = dequantize_int8(*quantize_int8(g32))
        return dq.to(g.dtype), g32 - dq
    pairs = tree_map(one, grads, error_state)     # (dq, err) leaves
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))
