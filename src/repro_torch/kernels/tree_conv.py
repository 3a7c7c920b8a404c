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

Its gradient is a `torch.autograd.Function` whose backward is a third
hand-written kernel, `tree_cnn_fused_backward` (csrc/tree_cnn_fused_bwd.cu),
in place of the reference's `_fused_bwd`, a jnp recomputation: it
recomputes the three layers and pulls the output cotangent back through
the max-pool (tied maxima share it evenly), the residual, the layers and
the children's gathers. Like the forward it runs a thread-block cluster
per tree, of 4 blocks: block r owns a slice of the output
channels for the recompute, the layers' g_z and the weight gradients,
and the same slice of the input width for the input gradient, after one
all-gather of g_z through distributed shared memory a layer; each
phase's weight slices are staged in shared memory with cp.async. The
weight gradients of all trees are summed in a second, fixed-order
launch and nothing uses float atomics, so a backward repeats bit for
bit. `tree_cnn_fused` takes the Function whenever autograd needs a
gradient of feat, mask or a weight, and the bare forward otherwise.
`tree_cnn_fused_bwd_launches` counts the backward's kernel launches on
the card: two a call, the per-tree cluster kernel and the summing
kernel. `backward_occupancy` reads the cluster kernel's launch shape and
occupancy.

Every wrapper runs its plain version (`ref.tree_conv_batch_ref`,
`ref.tree_cnn_fused_ref`, `ref.tree_cnn_fused_bwd_ref`) for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
`tree_cnn_fused_launches` counts the fused forward kernel's launches.
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
tree_cnn_fused_bwd_launches = 0   # kernel launches, two a backward call
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


def _forward(feat, left, right, mask, params: Params):
    """The fused forward on checked inputs: the plain version on the CPU,
    the kernel on CUDA."""
    global tree_cnn_fused_launches
    if feat.device.type == "cpu":
        return ref.tree_cnn_fused_ref(feat, left, right, mask, params)
    if feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {feat.device}")
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


def _bwd_library():
    from repro_torch.kernels import build
    fn = build.load("tree_cnn_fused_bwd").tree_cnn_fused_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def backward_occupancy(N: int, F: int, H: int) -> Dict[str, int]:
    """The backward's per-tree kernel at (N, F, H): its blocks a tree,
    threads and shared memory a block, and the card's occupancy for it
    (blocks an SM, clusters resident at once). Needs the card."""
    from repro_torch.kernels import build
    fn = build.load("tree_cnn_fused_bwd").tree_cnn_fused_backward_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(N, F, H, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"backward occupancy query failed: CUDA error "
                           f"{err}")
    keys = ("cluster", "threads", "smem_bytes", "blocks_per_sm",
            "max_active_clusters")
    return dict(zip(keys, out))


def _weight_shapes(Fd: int, H: int):
    """(layer, weight, shape) in the backward kernel's flat order."""
    return [(lname, w, (H,) if w == "b" else (Fd if i == 0 else H, H))
            for i, lname in enumerate(LAYERS) for w in WEIGHTS]


def tree_cnn_fused_backward(feat, left, right, mask, params: Params, g,
                            need_feat: bool = True, need_mask: bool = True):
    """The cotangents of `tree_cnn_fused`'s inputs for the output
    cotangent g (B, H): (gfeat (B, N, F) or None, gmask (B, N) or None,
    gparams nested as params). CPU tensors take the plain version
    (`ref.tree_cnn_fused_bwd_ref`); CUDA tensors launch the backward
    kernel or raise. gfeat and gmask are computed only when asked for."""
    global tree_cnn_fused_bwd_launches
    _check(feat, left, right, mask, params)
    B, N, Fd = feat.shape
    H = params["conv1"]["wr"].shape[-1]
    _check_all(feat, [(g, "g", torch.float32, (B, H))])
    if feat.device.type == "cpu":
        gf, gm, gp = ref.tree_cnn_fused_bwd_ref(feat, left, right, mask,
                                                params, g)
        return (gf if need_feat else None), (gm if need_mask else None), gp
    if feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {feat.device}")
    if Fd > MAX_HIDDEN:
        raise ValueError(f"the backward kernel takes F <= {MAX_HIDDEN}, "
                         f"got F={Fd}")
    shapes = _weight_shapes(Fd, H)
    E = sum(int(torch.Size(s).numel()) for _, _, s in shapes)
    dev = feat.device
    partial = torch.empty((max(B, 1), E), dtype=torch.float32, device=dev)
    flat = torch.empty(E, dtype=torch.float32, device=dev)
    gfeat = torch.empty_like(feat) if need_feat else None
    gmask = torch.empty_like(mask) if need_mask else None
    ptrs = [feat.data_ptr(), left.data_ptr(), right.data_ptr(),
            mask.data_ptr()]
    for lname in LAYERS:
        ptrs += [params[lname][w].data_ptr() for w in WEIGHTS]
    ptrs += [g.data_ptr(), partial.data_ptr(), flat.data_ptr(),
             0 if gfeat is None else gfeat.data_ptr(),
             0 if gmask is None else gmask.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_library()(*ptrs, B, N, Fd, H, stream)
    if err != 0:
        raise RuntimeError(f"tree_cnn_fused backward launch failed: CUDA "
                           f"error {err}")
    if B > 0:                  # per-tree cluster kernel + summing kernel
        tree_cnn_fused_bwd_launches += 2
    gparams = {lname: {} for lname in LAYERS}
    at = 0
    for lname, w, shape in shapes:
        n = int(torch.Size(shape).numel())
        gparams[lname][w] = flat[at:at + n].view(shape)
        at += n
    return gfeat, gmask, gparams


class _FusedTreeCNN(torch.autograd.Function):
    """`tree_cnn_fused` with its backward kernel: saves (feat, left,
    right, mask, weights) as the reference's `_fused_fwd` does."""

    @staticmethod
    def forward(ctx, feat, left, right, mask, *weights):
        params = _nest(weights)
        ctx.save_for_backward(feat, left, right, mask, *weights)
        return _forward(feat, left, right, mask, params)

    @staticmethod
    def backward(ctx, g):
        feat, left, right, mask, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        gfeat, gmask, gparams = tree_cnn_fused_backward(
            feat, left, right, mask, _nest(weights), g.contiguous(),
            need_feat=need[0], need_mask=need[3])
        return (gfeat, None, None, gmask,
                *(gparams[l][w] for l in LAYERS for w in WEIGHTS))


def _nest(weights) -> Params:
    it = iter(weights)
    return {l: {w: next(it) for w in WEIGHTS} for l in LAYERS}


def tree_cnn_fused(feat, left, right, mask, params: Params):
    """Fused TreeCNN encoder. feat (B, N, F) float32, left/right (B, N)
    int32 child indices (0 = the null slot), mask (B, N) float32, params
    {"conv1"|"conv2"|"conv3": {"wr","wl","wrt": (Din, H), "b": (H,)}}, all
    contiguous and on one device. Returns (B, H) float32, differentiable
    in feat, mask and the weights (through the backward kernel on CUDA)."""
    _check(feat, left, right, mask, params)
    weights = [params[l][w] for l in LAYERS for w in WEIGHTS]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (feat, mask, *weights)):
        return _FusedTreeCNN.apply(feat, left, right, mask, *weights)
    return _forward(feat, left, right, mask, params)


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
