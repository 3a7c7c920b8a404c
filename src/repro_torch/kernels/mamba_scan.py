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
h0) with the state before every CHUNK-th step written too
(`_forward(with_states=True)`; under remat the re-forward writes them
again) and keeps its inputs and those states, and whose backward
(`mamba_scan_bwd`) launches the two kernels of csrc/mamba_scan_bwd.cu: a
reverse scan in the forward kernel's layout (each chunk, last first,
recomputed from its kept state, rounded as the forward rounds it; x, dt,
the cotangent, B and C staged by asynchronous copies two chunks ahead;
dh carried back), whose blocks add their dB/dC terms over a cluster of up
to 8 blocks through distributed shared memory and write their dA/dD
partials, and a second launch that adds the partials in a fixed order: no
atomics, repeatable bit for bit. It returns the gradients of x, dt, A,
Bs, Cs, D and h0. Without gradients the forward writes no states. For CPU
tensors the Function saves the plain states (`ref.mamba_scan_ref(chunk=
CHUNK)`) and runs the plain backward `ref.mamba_scan_bwd_ref` from them,
for `meta` ones it returns the empty fakes; under an op counter the
forward records `work.scan_work` (with the states' bytes when written)
and the backward `work.scan_bwd_work`. `bwd_launches` counts the
backward's launches, two a call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, work
from repro_torch.launch import opanalysis

STATES = (4, 8, 16, 32)   # the kernel's state sizes N

launches = 0              # kernel launches (not plain-version calls)
bwd_launches = 0          # backward kernel launches, two a call
# the forward kernel's kStateT and the backward's kT (csrc/mamba_scan.cu,
# csrc/mamba_scan_bwd.cu): steps between the states the forward keeps for
# the backward, which sizes the states tensor
CHUNK = 16


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
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, A, Bs, Cs, y, h_last, D=None, h0=None,
            states=None) -> int:
    """Launch the kernel on checked CUDA tensors (D, h0 and states may
    be None); returns the CUDA error code (0 = launched)."""
    B, S, di = x.shape

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        return _library()(*(t.data_ptr() for t in (x, dt, A, Bs, Cs)),
                          ptr(D), ptr(h0), y.data_ptr(), h_last.data_ptr(),
                          ptr(states), B, S, di, A.shape[1],
                          torch.cuda.current_stream().cuda_stream)


def _forward(x, dt, A, Bs, Cs, D, h0, with_states=False):
    """The kernel's function on checked tensors: one counted launch on
    CUDA, the plain version on the CPU, the kernel's fake on `meta`;
    recorded for an active op counter. With `with_states`, (y, h_last,
    states): also the states before every CHUNK-th step (B, ceil(S /
    CHUNK), di, N), which the backward starts its chunks from."""
    global launches
    B, S, di = x.shape
    N = A.shape[1]
    cost = work.scan_work(B, S, di, N, skip=D is not None,
                          h0=h0 is not None,
                          states=CHUNK if with_states else 0)
    with opanalysis.kernel("mamba_scan", cost[1], cost[0]):
        if x.device.type == "cpu":
            return _plain(x, dt, A, Bs, Cs, D, h0, with_states)
        y = torch.empty_like(x)
        f32 = dict(dtype=torch.float32, device=x.device)
        h_last = torch.empty((B, di, N), **f32)
        states = (torch.empty((B, -(-S // CHUNK), di, N), **f32)
                  if with_states else None)
        outs = (y, h_last, states) if with_states else (y, h_last)
        if x.device.type == "meta":
            return outs
        err = _launch(x, dt, A, Bs, Cs, y, h_last, D, h0, states)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return outs


def _plain(x, dt, A, Bs, Cs, D, h0, with_states=False):
    """The kernel's function by its plain version: (y (+ x·D), h_last),
    and with `with_states` the states the kernel keeps."""
    y, h, *states = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0,
                                       CHUNK if with_states else None)
    return ((y if D is None else y + x * D), h, *states)


def _bwd_library():
    from repro_torch.kernels import build
    fn = build.load("mamba_scan_bwd").mamba_scan_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bwd_parts(di) -> int:
    """The backward kernel's dB/dC partials at this d_inner: one a
    thread-block cluster of up to 8 blocks of 16 channels."""
    from repro_torch.kernels import build
    fn = build.load("mamba_scan_bwd").mamba_scan_bwd_parts
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(int(di))


def mamba_scan_bwd(x, dt, A, Bs, Cs, D, h0, gy, gh, states=None):
    """The backward kernel's function on checked tensors (`mamba_scan`'s
    inputs; gy (B, S, di) and gh (B, di, N), the cotangents of y and
    h_last, each fp32 and contiguous or None; `states`, the forward's
    chunk states as `_forward(with_states=True)` returns them): (dx, ddt,
    dA, dB, dC, dD, dh0), fp32, dD None without D and dh0 None without
    h0. Two counted launches on CUDA, which need the forward kernel's
    `states`; the plain backward on the CPU (from `states` if given);
    empty fakes on `meta`; recorded for an active op counter."""
    global bwd_launches
    B, S, di = x.shape
    N = A.shape[1]
    cost = work.scan_bwd_work(B, S, di, N, skip=D is not None,
                              h0=h0 is not None, gy=gy is not None,
                              gh=gh is not None, states=CHUNK)
    with opanalysis.kernel("mamba_scan_bwd", cost[1], cost[0]):
        if x.device.type == "cpu":
            return ref.mamba_scan_bwd_ref(x, dt, A, Bs, Cs, D, h0, gy, gh,
                                          states, CHUNK)
        grads = [torch.empty_like(t) for t in (x, dt, A, Bs, Cs)]
        grads += [None if t is None else torch.empty_like(t)
                  for t in (D, h0)]
        if x.device.type == "meta":
            return tuple(grads)
        want = (B, -(-S // CHUNK), di, N)
        if (states is None or tuple(states.shape) != want
                or states.dtype != torch.float32
                or states.device != x.device or not states.is_contiguous()):
            raise ValueError(f"the scan backward kernel starts from the "
                             f"forward kernel's chunk states: states must be "
                             f"{want} fp32, contiguous, on x's device")
        f32 = dict(dtype=torch.float32, device=x.device)
        part_bc = torch.empty((bwd_parts(di), 2, B, S, N), **f32)
        part_ad = torch.empty((B, di * (N + 1)), **f32)

        def ptr(t):
            return None if t is None else t.data_ptr()
        with torch.cuda.device(x.device):
            err = _bwd_library()(
                *(ptr(t) for t in (x, dt, A, Bs, Cs, D, h0, gy, gh, states,
                                   *grads, part_bc, part_ad)),
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
        y, h_last, states = _forward(x, dt, A, Bs, Cs, D, h0,
                                     with_states=True)
        ctx.save_for_backward(x, dt, A, Bs, Cs, D, h0, states)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors       # once: a remat checkpoint unpacks once
        ins, states = saved[:7], saved[7]
        grads = mamba_scan_bwd(*ins, *(None if g is None else g.contiguous()
                                       for g in (gy, gh)), states)
        return tuple(d if w and t is not None else None
                     for d, t, w in zip(grads, ins, ctx.needs_input_grad))


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
