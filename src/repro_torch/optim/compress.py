"""int8 gradient compression with error feedback, as the reference's
`repro/optim/compress.py`: per-tensor symmetric int8, and the
quantization residual carried to the next step so that the noise is a
moving average, not a bias (Seide et al.).

`torch.round` rounds half to even, as `jnp.round` does. Divisions divide
by tensors (a CUDA tensor divided by a Python number is multiplied by its
reciprocal, which rounds otherwise). `compressed_psum` is the reference's
explicit compressed all-reduce, over a `torch.distributed` group where
the reference's runs inside `shard_map`.
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


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Explicit compressed all-reduce over `group` (the default group if
    None): int8 wire payload, int32 accumulation, fp32 result. The scale
    is itself all-reduced (max) so dequantization is consistent across
    ranks, and each rank requantizes against that global scale so that
    the sum is exact in int32."""
    import torch.distributed as dist
    x32 = x.to(torch.float32)
    _, s = quantize_int8(x32)
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    tot = q.to(torch.int32)
    dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
    return tot.to(torch.float32) * s
