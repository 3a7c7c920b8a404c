"""Mesh descriptors, as the reference's `repro.launch.mesh`: axis names
and sizes, with no process group. A dry run on one card names the layout
it plans for (`make_production_mesh`); `make_host_mesh` describes the
CUDA devices of this host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[str, ...] = ()     # the devices it names, if any

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod.

    Axes: data (FSDP/batch), model (TP/expert). The multi-pod mesh adds a
    leading pure-DP "pod" axis: parameters are never sharded across it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh() -> Mesh:
    """(1, n) over the CUDA devices there are; (1, 1) over the CPU where
    there is none."""
    import torch
    n = torch.cuda.device_count()
    devices = tuple(f"cuda:{i}" for i in range(n)) if n else ("cpu",)
    return Mesh(("data", "model"), (1, len(devices)), devices)
