"""Mamba-1 selective scan: a hand-written CUDA kernel for Hopper (its
plain PyTorch version is in `ref`).

Replaces `repro/kernels/mamba_scan.py::mamba_scan` (the Pallas TPU kernel
`_kernel`): h_t = exp(dt_t·A)⊙h_{t−1} + (dt_t·x_t)⊗B_t from h = 0 and
y_t = Σ_n C_t[n]·h_t[:, n]; x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N)
-> y (B, S, di). Given `D` (di,), the kernel adds the Mamba block's skip
term x·D in its write-back, so `ops.selective_scan_fused` is one launch.
Beyond the Pallas kernel, which returns y alone, it starts from a given
state `h0` (B, di, N) and also returns the state after the last step,
h_last (B, di, N): what a Mamba prefill leaves in the decode cache.

What bounds it on an H100: device memory and the special-function
units. At falcon-mamba-7b's widths a call reads x and dt and writes y,
201 MB, and takes 268M exps, each about as long on the card's
special-function units as the bytes on its memory. The scan runs
sequentially in time in fp32, as the TPU kernel's does. Each channel's N
states are split over lanes (8 at N = 16) so that the SMs fill; each
lane sums its states' share of y_t for a group of steps and one
reduce-scatter over the lanes finishes them (`ref.mamba_scan_lanes_ref`
is that order of sums); h is rounded op by op as the plain version
rounds it; x, dt, B and C arrive in shared memory by
asynchronous copies, chunks ahead (csrc/mamba_scan.cu says more).

`mamba_scan` runs its plain version, `ref.mamba_scan_ref`, for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
`launches` counts launches.

Gradients: the kernel has no backward, nor has the reference's Pallas
kernel. With gradients on, a CUDA call goes through `MambaScan`, a
`torch.autograd.Function` whose forward launches the kernel (with D and
h0) and keeps its inputs, and whose backward runs the plain version
again on them (plus x·D) under autograd and returns the gradients of x,
dt, A, Bs, Cs, D and h0. That plain backward is a Python loop over the
S steps, each a few small launches. On the CPU the plain version is
differentiable as it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

STATES = (4, 8, 16, 32)   # the kernel's state sizes N

launches = 0              # kernel launches (not plain-version calls)


def _check(x, dt, A, Bs, Cs, D=None, h0=None):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be (B, S, di) and A (di, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    B, S, di = x.shape
    N = A.shape[1]
    if S < 1:
        raise ValueError("the scan needs at least one time step")
    for t, name, shape in ((x, "x", (B, S, di)), (dt, "dt", (B, S, di)),
                           (A, "A", (di, N)), (Bs, "Bs", (B, S, N)),
                           (Cs, "Cs", (B, S, N)),
                           *(() if D is None else ((D, "D", (di,)),)),
                           *(() if h0 is None else ((h0, "h0", (B, di, N)),))):
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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, A, Bs, Cs, y, h_last, D=None, h0=None) -> int:
    """Launch the kernel on checked CUDA tensors (D and h0 may be None);
    returns the CUDA error code (0 = launched)."""
    B, S, di = x.shape

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        return _library()(*(t.data_ptr() for t in (x, dt, A, Bs, Cs)),
                          ptr(D), ptr(h0), y.data_ptr(), h_last.data_ptr(),
                          B, S, di, A.shape[1],
                          torch.cuda.current_stream().cuda_stream)


def _forward(x, dt, A, Bs, Cs, D, h0):
    """One counted kernel launch on checked CUDA tensors."""
    global launches
    y = torch.empty_like(x)
    h_last = torch.empty((x.shape[0], x.shape[2], A.shape[1]),
                         dtype=torch.float32, device=x.device)
    err = _launch(x, dt, A, Bs, Cs, y, h_last, D, h0)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h_last


def _plain(x, dt, A, Bs, Cs, D, h0):
    """The kernel's function by its plain version: (y (+ x·D), h_last)."""
    y, h = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
    return (y if D is None else y + x * D), h


class MambaScan(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version on
    the saved inputs and returns its gradients (None where an input is
    absent or needs none)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bs, Cs, D, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bs, Cs, D, h0)
        return _forward(x, dt, A, Bs, Cs, D, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors       # once: a remat checkpoint unpacks once
        want = [w and t is not None
                for t, w in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(saved, want)]
            outs = [(o, g) for o, g in zip(_plain(*ins), (gy, gh))
                    if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], [t for t, w in zip(ins, want) if w],
                [g for _, g in outs], allow_unused=True))
        return tuple(next(grads) if w else None for w in want)


def mamba_scan(x, dt, A, Bs, Cs, D=None, h0=None):
    """Selective scan. x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N) and,
    if given, the skip weights D (di,) and the initial state h0
    (B, di, N), all float32, contiguous and on one device; S >= 1.
    Returns (y (B, S, di), plus x·D if D is given; h_last (B, di, N)),
    float32; with gradients on and an input that needs one,
    differentiable (`MambaScan`)."""
    _check(x, dt, A, Bs, Cs, D, h0)
    if x.device.type == "cpu":
        return _plain(x, dt, A, Bs, Cs, D, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if A.shape[1] not in STATES:
        raise ValueError(f"the kernel takes N in {STATES}, got N={A.shape[1]}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bs, Cs, D, h0)):
        return MambaScan.apply(x, dt, A, Bs, Cs, D, h0)
    return _forward(x, dt, A, Bs, Cs, D, h0)
