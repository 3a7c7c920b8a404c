"""Flash attention: a hand-written CUDA kernel for Hopper (its plain
PyTorch version is in `ref`).

Replaces `repro/kernels/flash_attention.py::flash_attention` (the Pallas
TPU kernel `_kernel`): q (BH, Sq, hd), k/v (BKV, Sk, hd) with GQA (query
row b reads k/v row b // G, G = BH / BKV); queries right-aligned against
the keys (qpos = i + Sk − Sq); key padding, causal and sliding-window
masks; an optional tanh softcap after the scale; online softmax with fp32
accumulators; a fully-masked row gives 0. The output is in q's dtype.

What bounds it on an H100: operations, 4·hd flops per allowed (query, key)
pair and head, except in decoding, where the bytes of k and v do. Three
kernels, one launch per call, picked by `kernel_path` from the shapes:

- "wgmma": bf16 prefill, 128 query rows a block on two consumer
  warpgroups, k/v tiles fed by TMA, both products on wgmma;
- "decode": bf16 when the Sq·G query rows of one k/v head fit one
  16-row tile; they are packed into it, and the keys are split over the
  8 blocks of a cluster, whose partials merge through distributed shared
  memory (`ref.flash_attention_split_ref` is this algorithm in PyTorch);
- "fp32": exactly on the FMA units, without TF32.

Key tiles with no allowed key are skipped, so a sliding window costs
O(Sq·window) (csrc/flash_attention.cu says more).

`flash_attention` runs its plain version, `ref.flash_attention_ref`, for
CPU tensors only; for CUDA tensors it launches a kernel or raises; for
`meta` tensors (a dry run) it returns the kernel's fake, an empty output
of its shape. Any other device raises. `launches` counts launches. Under
an active op counter (`launch.opanalysis`) each call records the
kernel's FLOPs and bytes (`work.attention_work`), whatever the device,
and the counter does not count the wrapper's own ops: a count on the CPU
or on `meta` is the card's.

Gradients: the kernel has no backward, nor has the reference's Pallas
kernel. With gradients on, a call goes through `FlashAttention`, a
`torch.autograd.Function` whose forward launches the kernel (its plain
version on the CPU) and keeps q, k and v, and whose backward runs the
plain version again on them under autograd and returns its gradients
(the shape of the reference's `tree_cnn_fused` VJP: the kernel forward, a
recomputation backward). On the CPU that gives autograd's own gradients
of the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, work
from repro_torch.launch import opanalysis

HEAD_DIMS = (32, 64, 128)     # the kernel's head widths
DTYPES = (torch.float32, torch.bfloat16)
DECODE_ROWS = 16              # packed query rows of the decode kernel's tile
DECODE_TILE = 64              # keys per stage of the decode kernel
DECODE_SPLITS = 8             # blocks of a cluster, each a share of the keys
PATHS = {"fp32": 0, "wgmma": 1, "decode": 2}   # the C entry point's codes
MAX_GRID_Y = 65535

launches = 0                  # kernel launches (not plain-version calls)


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, hd) and k (BKV, Sk, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    BH, _, hd = q.shape
    BKV, Sk, _ = k.shape
    if BKV == 0 or BH % BKV != 0:
        raise ValueError(f"BH={BH} is not a multiple of BKV={BKV}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {DTYPES}, got {q.dtype}")
    for t, name, shape in ((k, "k", (BKV, Sk, hd)), (v, "v", (BKV, Sk, hd))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def kernel_path(BH, BKV, Sq, Sk, hd, dtype) -> str:
    """The kernel that takes a call with these shapes: "fp32", "wgmma" or
    "decode". Raises for a shape no kernel takes."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS}, got hd={hd}")
    if dtype == torch.float32:
        path, rows = "fp32", BH
    elif Sq * (BH // BKV) <= DECODE_ROWS:
        path, rows = "decode", BKV
    elif Sk > 0:
        path, rows = "wgmma", BH
    else:
        raise ValueError("no bf16 kernel takes Sk=0 with more than "
                         f"{DECODE_ROWS} query rows per k/v head")
    if rows > MAX_GRID_Y:
        raise ValueError(f"the {path} kernel takes at most {MAX_GRID_Y} "
                         f"rows of q or k/v, got {rows}")
    return path


def _library():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, out, *, causal, window, softcap, scale) -> int:
    """Launch the kernel `kernel_path` picks on checked CUDA tensors;
    returns the CUDA error code (0 = launched)."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    path = kernel_path(BH, BKV, Sq, Sk, hd, q.dtype)
    scale = hd ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        return _library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, BKV, Sq, Sk, hd, PATHS[path], int(causal),
            int(window or 0), float(scale), float(softcap or 0.0),
            torch.cuda.current_stream().cuda_stream)


def _forward(q, k, v, *, causal, window, softcap, scale):
    """The kernel's function on checked tensors: one counted launch on
    CUDA, the plain version on the CPU, the kernel's fake on `meta`;
    recorded for an active op counter."""
    global launches
    BH, Sq, hd = q.shape
    cost = work.attention_work(BH, k.shape[0], Sq, k.shape[1], hd,
                               causal=causal, window=window,
                               itemsize=q.element_size())
    with opanalysis.kernel("flash_attention", cost[1], cost[0]):
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           scale=scale)
        out = torch.empty_like(q)
        if q.device.type == "meta":
            return out
        err = _launch(q, k, v, out, causal=causal, window=window,
                      softcap=softcap, scale=scale)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version
    (`ref.flash_attention_ref`) on the saved q, k and v and returns its
    gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, **kw)

    @staticmethod
    def backward(ctx, g):
        want = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(w)
                   for t, w in zip(ctx.saved_tensors, want)]
            out = ref.flash_attention_ref(*qkv, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t, w in zip(qkv, want) if w], g))
        return (*(next(grads) if w else None for w in want),
                None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None):
    """q (BH, Sq, hd), k/v (BKV, Sk, hd) with BH % BKV == 0, all float32
    or all bfloat16, contiguous and on one device. Scale defaults to
    hd^-0.5. Returns (BH, Sq, hd) in q's dtype; with gradients on and an
    input that needs one, differentiable (`FlashAttention`)."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    if q.device.type != "cpu":
        kernel_path(q.shape[0], k.shape[0], q.shape[1], k.shape[1],
                    q.shape[2], q.dtype)
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale)
