"""Tree convolution: two hand-written CUDA kernels for Hopper, each with
a launch counter (their plain PyTorch versions are in `ref`).

`tree_conv` replaces `repro/kernels/tree_conv.py::tree_conv` (the Pallas
TPU kernel `_kernel`): one Neo tree-conv layer, feat (B, N, F) ->
(B, N, H), with the children gathered from shared memory where the TPU
version multiplies by (B, N, N) one-hots (csrc/tree_conv.cu says more).
It counts its launches in `tree_conv_launches`.

`tree_cnn_fused` replaces `repro/kernels/tree_conv.py::tree_cnn_fused`
(the Pallas TPU kernel `_fused_kernel`). Per tree: three Neo tree-conv layers
`leaky_relu(h·Wr + h[left]·Wl + h[right]·Wrt + b)·mask`, a residual on
layer 3 and a masked max-pool over the nodes (all-masked -> 0); feat
(B, N, F) -> (B, H). A child index outside [0, N) reads a zero row, as
the reference's in-kernel one-hot does.

What bounds it on an H100: at the serving shape (B=8 lanes, N=48, F=26,
H=96) one call does about 48 MFLOP of fp32 FMAs and reads about 0.3 MB,
most of it the three layers' weights (251 KB). At the card's peaks that
is under a microsecond, so latency bounds it: the launch and the chain of
dependent steps inside. The design answers with one launch per encoder
call for all three layers and the pool, no intermediate activation in
device memory, no allocation or sync inside, and a thread-block cluster
of 8 blocks per tree so that 8 trees keep 64 SMs busy: each block owns
H/8 output channels, stages its slice of the weights in shared memory
once, gathers children from shared memory, and fetches the other blocks'
channels through distributed shared memory between layers
(csrc/tree_cnn_fused.cu says more).

Both wrappers run their plain versions (`ref.tree_conv_batch_ref`,
`ref.tree_cnn_fused_ref`) for CPU tensors only; for CUDA tensors they
launch the kernel or raise. `tree_cnn_fused_launches` counts the fused
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import ref

LAYERS = ("conv1", "conv2", "conv3")
WEIGHTS = ("wr", "wl", "wrt", "b")
MAX_NODES = 64        # the kernels' per-tree node limit (encoding.MAX_NODES)
MAX_HIDDEN = 128      # 32 node groups x H/8 channels per block <= 512
MAX_FEAT = 512        # tree_conv's input width limit (shared memory)

tree_cnn_fused_launches = 0    # kernel launches (not plain-version calls)
tree_conv_launches = 0         # kernel launches (not plain-version calls)

Params = Dict[str, Dict[str, torch.Tensor]]


def _tree_inputs(feat, left, right, mask):
    """(tensor, name, dtype, shape) of a tree batch's four inputs."""
    if feat.dim() != 3:
        raise ValueError(f"feat must be (B, N, F), got {tuple(feat.shape)}")
    B, N, Fd = feat.shape
    return [(feat, "feat", torch.float32, (B, N, Fd)),
            (left, "left", torch.int32, (B, N)),
            (right, "right", torch.int32, (B, N)),
            (mask, "mask", torch.float32, (B, N))]


def _check_all(feat, expect):
    for t, name, dtype, shape in expect:
        if t.device != feat.device:
            raise ValueError(f"{name} is on {t.device}, feat on {feat.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(feat, left, right, mask, params: Params):
    expect = _tree_inputs(feat, left, right, mask)
    B, N, Fd = feat.shape
    H = params["conv1"]["wr"].shape[-1]
    for i, lname in enumerate(LAYERS):
        d_in = Fd if i == 0 else H
        for w in WEIGHTS:
            shape = (H,) if w == "b" else (d_in, H)
            expect.append((params[lname][w], f"{lname}.{w}", torch.float32,
                           shape))
    _check_all(feat, expect)
    if N > MAX_NODES or H > MAX_HIDDEN:
        raise ValueError(f"the kernel takes N <= {MAX_NODES} and "
                         f"H <= {MAX_HIDDEN}, got N={N}, H={H}")


def _library():
    from repro_torch.kernels import build
    fn = build.load("tree_cnn_fused").tree_cnn_fused_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tree_cnn_fused(feat, left, right, mask, params: Params):
    """Fused TreeCNN encoder. feat (B, N, F) float32, left/right (B, N)
    int32 child indices (0 = the null slot), mask (B, N) float32, params
    {"conv1"|"conv2"|"conv3": {"wr","wl","wrt": (Din, H), "b": (H,)}}, all
    contiguous and on one device. Returns (B, H) float32."""
    global tree_cnn_fused_launches
    _check(feat, left, right, mask, params)
    if feat.device.type == "cpu":
        return ref.tree_cnn_fused_ref(feat, left, right, mask, params)
    if feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {feat.device}")
    if torch.is_grad_enabled() and any(
            params[l][w].requires_grad for l in LAYERS for w in WEIGHTS):
        raise NotImplementedError(
            "the fused kernel has no backward yet; it comes with the "
            "training slice (ROADMAP Queue B1)")
    B, N, Fd = feat.shape
    H = params["conv1"]["wr"].shape[-1]
    out = torch.empty((B, H), dtype=torch.float32, device=feat.device)
    ptrs = [feat.data_ptr(), left.data_ptr(), right.data_ptr(),
            mask.data_ptr()]
    for lname in LAYERS:
        ptrs += [params[lname][w].data_ptr() for w in WEIGHTS]
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(*ptrs, out.data_ptr(), B, N, Fd, H, stream)
    if err != 0:
        raise RuntimeError(f"tree_cnn_fused launch failed: CUDA error {err}")
    tree_cnn_fused_launches += 1
    return out


def _conv_library():
    from repro_torch.kernels import build
    fn = build.load("tree_conv").tree_conv_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _conv_launch(feat, left, right, mask, wr, wl, wrt, b, out) -> int:
    """Launch the tree_conv kernel on checked CUDA tensors; returns the
    CUDA error code (0 = launched)."""
    B, N, Fd = feat.shape
    with torch.cuda.device(feat.device):
        return _conv_library()(
            *(t.data_ptr() for t in (feat, left, right, mask, wr, wl, wrt,
                                     b, out)),
            B, N, Fd, wr.shape[1], torch.cuda.current_stream().cuda_stream)


def tree_conv(feat, left, right, mask, wr, wl, wrt, b):
    """One tree-conv layer. feat (B, N, F) float32, left/right (B, N)
    int32 child indices (0 = the null slot), mask (B, N) float32, wr/wl/wrt
    (F, H) and b (H,) float32, all contiguous and on one device. Returns
    (B, N, H) float32."""
    global tree_conv_launches
    expect = _tree_inputs(feat, left, right, mask)
    if wr.dim() != 2:
        raise ValueError(f"wr must be (F, H), got {tuple(wr.shape)}")
    B, N, Fd = feat.shape
    H = wr.shape[1]
    expect += [(w, name, torch.float32, (Fd, H))
               for w, name in ((wr, "wr"), (wl, "wl"), (wrt, "wrt"))]
    expect.append((b, "b", torch.float32, (H,)))
    _check_all(feat, expect)
    if feat.device.type == "cpu":
        return ref.tree_conv_batch_ref(feat, left, right, mask, wr, wl, wrt,
                                       b)
    if feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {feat.device}")
    if N > MAX_NODES or Fd > MAX_FEAT:
        raise ValueError(f"the kernel takes N <= {MAX_NODES} and "
                         f"F <= {MAX_FEAT}, got N={N}, F={Fd}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (feat, mask, wr, wl, wrt, b)):
        raise NotImplementedError("the tree_conv kernel has no backward")
    out = torch.empty((B, N, H), dtype=torch.float32, device=feat.device)
    err = _conv_launch(feat, left, right, mask, wr, wl, wrt, b, out)
    if err != 0:
        raise RuntimeError(f"tree_conv launch failed: CUDA error {err}")
    tree_conv_launches += 1
    return out
