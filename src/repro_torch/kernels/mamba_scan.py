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
tensors only; for CUDA tensors it launches the kernel or raises; for
`meta` tensors (a dry run) it returns the kernel's fake, empty outputs of
its shapes. Any other device raises. `launches` counts launches. Under
an active op counter (`launch.opanalysis`) each call records the
kernel's FLOPs and bytes (`work.scan_work`), whatever the device, and the
counter does not count the wrapper's own ops.

Gradients: the reference's Pallas kernel has no VJP (its LMs train
through jnp autodiff of the plain oracle's `lax.scan`); here the backward
is a kernel too. With gradients on, a call goes through `MambaScan`, a
`torch.autograd.Function` whose forward launches the kernel (with D and
h0) and keeps its inputs, and whose backward (`mamba_scan_bwd`) launches
the two kernels of csrc/mamba_scan_bwd.cu: a reverse scan in the forward
kernel's layout (a forward pass keeps h at chunk boundaries in a scratch
tensor, then each chunk, last first, recomputes its states from its
boundary, rounded as the forward rounds them, and carries dh back),
whose blocks write partial sums of dB, dC, dA and dD, and a second launch
that adds the partials in a fixed order: no atomics, repeatable bit for
bit. It returns the gradients of x, dt, A, Bs, Cs, D and h0. For CPU
tensors it runs the plain backward `ref.mamba_scan_bwd_ref`, for `meta`
ones it returns the empty fakes; under an op counter it records
`work.scan_bwd_work`. `bwd_launches` counts its launches, two a call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, work
from repro_torch.launch import opanalysis

STATES = (4, 8, 16, 32)   # the kernel's state sizes N

launches = 0              # kernel launches (not plain-version calls)
bwd_launches = 0          # backward kernel launches, two a call
# the backward kernel's kT and kCh (csrc/mamba_scan_bwd.cu), which size
# its scratch: steps between the states it keeps, channels a block
CHUNK, CHANNELS = 16, 32


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
    """The kernel's function on checked tensors: one counted launch on
    CUDA, the plain version on the CPU, the kernel's fake on `meta`;
    recorded for an active op counter."""
    global launches
    B, S, di = x.shape
    cost = work.scan_work(B, S, di, A.shape[1], skip=D is not None,
                          h0=h0 is not None)
    with opanalysis.kernel("mamba_scan", cost[1], cost[0]):
        if x.device.type == "cpu":
            return _plain(x, dt, A, Bs, Cs, D, h0)
        y = torch.empty_like(x)
        h_last = torch.empty((B, di, A.shape[1]), dtype=torch.float32,
                             device=x.device)
        if x.device.type == "meta":
            return y, h_last
        err = _launch(x, dt, A, Bs, Cs, y, h_last, D, h0)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h_last


def _plain(x, dt, A, Bs, Cs, D, h0):
    """The kernel's function by its plain version: (y (+ x·D), h_last)."""
    y, h = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
    return (y if D is None else y + x * D), h


def _bwd_library():
    from repro_torch.kernels import build
    fn = build.load("mamba_scan_bwd").mamba_scan_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mamba_scan_bwd(x, dt, A, Bs, Cs, D, h0, gy, gh):
    """The backward kernel's function on checked tensors (`mamba_scan`'s
    inputs; gy (B, S, di) and gh (B, di, N), the cotangents of y and
    h_last, each fp32 and contiguous or None): (dx, ddt, dA, dB, dC, dD,
    dh0), fp32, dD None without D and dh0 None without h0. Two counted
    launches on CUDA, the plain backward on the CPU, empty fakes on
    `meta`; recorded for an active op counter."""
    global bwd_launches
    B, S, di = x.shape
    N = A.shape[1]
    cost = work.scan_bwd_work(B, S, di, N, skip=D is not None,
                              h0=h0 is not None, gy=gy is not None,
                              gh=gh is not None)
    with opanalysis.kernel("mamba_scan_bwd", cost[1], cost[0]):
        if x.device.type == "cpu":
            return ref.mamba_scan_bwd_ref(x, dt, A, Bs, Cs, D, h0, gy, gh)
        grads = [torch.empty_like(t) for t in (x, dt, A, Bs, Cs)]
        grads += [None if t is None else torch.empty_like(t)
                  for t in (D, h0)]
        if x.device.type == "meta":
            return tuple(grads)
        chunks = -(-S // CHUNK)
        blocks = -(-di // CHANNELS)
        f32 = dict(dtype=torch.float32, device=x.device)
        states = torch.empty((B, chunks, di, N), **f32)
        part_bc = torch.empty((blocks, 2, B, S, N), **f32)
        part_ad = torch.empty((B, di * (N + 1)), **f32)

        def ptr(t):
            return None if t is None else t.data_ptr()
        with torch.cuda.device(x.device):
            err = _bwd_library()(
                *(ptr(t) for t in (x, dt, A, Bs, Cs, D, h0, gy, gh,
                                   *grads, states, part_bc, part_ad)),
                B, S, di, N, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan backward launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 2
    return tuple(grads)


class MambaScan(torch.autograd.Function):
    """The forward kernel; the backward kernels (`mamba_scan_bwd`) on the
    saved inputs (None where an input is absent or needs no gradient)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bs, Cs, D, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bs, Cs, D, h0)
        return _forward(x, dt, A, Bs, Cs, D, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors       # once: a remat checkpoint unpacks once
        grads = mamba_scan_bwd(*saved, *(None if g is None else g.contiguous()
                                         for g in (gy, gh)))
        return tuple(d if w and t is not None else None
                     for d, t, w in zip(grads, saved, ctx.needs_input_grad))


def mamba_scan(x, dt, A, Bs, Cs, D=None, h0=None):
    """Selective scan. x/dt (B, S, di), A (di, N), Bs/Cs (B, S, N) and,
    if given, the skip weights D (di,) and the initial state h0
    (B, di, N), all float32, contiguous and on one device; S >= 1.
    Returns (y (B, S, di), plus x·D if D is given; h_last (B, di, N)),
    float32; with gradients on and an input that needs one,
    differentiable (`MambaScan`)."""
    _check(x, dt, A, Bs, Cs, D, h0)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    if x.device.type != "cpu" and A.shape[1] not in STATES:
        raise ValueError(f"the kernel takes N in {STATES}, got N={A.shape[1]}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bs, Cs, D, h0)):
        return MambaScan.apply(x, dt, A, Bs, Cs, D, h0)
    return _forward(x, dt, A, Bs, Cs, D, h0)
