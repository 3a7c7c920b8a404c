"""Mamba-1 selective scan: a hand-written CUDA kernel for Hopper (its
plain PyTorch version is in `ref`).

Replaces `repro/kernels/mamba_scan.py::mamba_scan` (the Pallas TPU kernel
`_kernel`): h_t = exp(dt_t·A)⊙h_{t−1} + (dt_t·x_t)⊗B_t from h = 0 and
y_t = Σ_n C_t[n]·h_t[:, n]; x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N)
-> y (B, S, di). Only y is returned, as the Pallas kernel does.

What bounds it on an H100: device memory. At falcon-mamba-7b's widths a
call reads x and dt and writes y, 201 MB; its 268M exps and ~1.9 GFLOP
take half as long at the fp32 rate. The scan runs sequentially in time in
fp32, as the TPU kernel's does; each channel's N states are split over
four lanes so that the card has enough warps, and each time step's B_t
and C_t are staged once in shared memory for all of a block's channels
(csrc/mamba_scan.cu says more).

`mamba_scan` runs its plain version, y of `ref.mamba_scan_ref`, for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
`launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

STATES = (4, 8, 16, 32)   # the kernel's state sizes N

launches = 0              # kernel launches (not plain-version calls)


def _check(x, dt, A, Bs, Cs):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be (B, S, di) and A (di, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    B, S, di = x.shape
    N = A.shape[1]
    for t, name, shape in ((x, "x", (B, S, di)), (dt, "dt", (B, S, di)),
                           (A, "A", (di, N)), (Bs, "Bs", (B, S, N)),
                           (Cs, "Cs", (B, S, N))):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    from repro_torch.kernels import build
    fn = build.load("mamba_scan").mamba_scan_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, A, Bs, Cs, y) -> int:
    """Launch the kernel on checked CUDA tensors; returns the CUDA error
    code (0 = launched)."""
    B, S, di = x.shape
    with torch.cuda.device(x.device):
        return _library()(*(t.data_ptr() for t in (x, dt, A, Bs, Cs, y)),
                          B, S, di, A.shape[1],
                          torch.cuda.current_stream().cuda_stream)


def mamba_scan(x, dt, A, Bs, Cs):
    """Selective scan. x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N), all
    float32, contiguous and on one device. Returns y (B, S, di) float32."""
    global launches
    _check(x, dt, A, Bs, Cs)
    if x.device.type == "cpu":
        return ref.mamba_scan_ref(x, dt, A, Bs, Cs)[0]
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if A.shape[1] not in STATES:
        raise ValueError(f"the kernel takes N in {STATES}, got N={A.shape[1]}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bs, Cs)):
        raise NotImplementedError("the mamba_scan kernel has no backward")
    y = torch.empty_like(x)
    err = _launch(x, dt, A, Bs, Cs, y)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return y
