"""LR schedules (pure functions of the step scalar), as the reference's
`repro/optim/schedule.py`.

The arithmetic is the reference's, in fp32: each Python constant is
rounded to fp32 where jnp rounds it (a product of two Python floats is
taken in double first, as Python takes it). The two divisions divide by a
tensor on the step's device, because a CUDA tensor divided by a Python
number is multiplied by its reciprocal instead. A step tensor on the card
gives a tensor on the card, with no host sync.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine to floor*peak. Returns multiplier in [0,1]
    as an fp32 scalar tensor on the step's device (the CPU for a Python
    number)."""
    step = (step.to(torch.float32) if isinstance(step, torch.Tensor)
            else torch.tensor(float(step), dtype=torch.float32))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=step.device)
    warm = torch.clamp(step / f32(max(warmup, 1)), max=1.0)
    prog = torch.clamp((step - warmup) / f32(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
