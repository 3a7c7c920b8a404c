"""`jax.random`'s normal and Gumbel draws: a hand-written CUDA kernel for
Hopper (its plain PyTorch versions are in `ref`).

Not a TPU kernel: the reference draws its LM weights
(`repro/models/common.py::normal_init`) and its sampled tokens
(`jax.random.categorical` in `repro/launch/serve.py`) with `jax.random`,
and this kernel draws the same numbers, bit for bit, on the card.
csrc/threefry.cu computes, for each uint32[2] key of a stack and each
element i of a slice [offset, offset + n) of the key's flat draw, the
partitionable Threefry-2x32 bits of counter i, jax's uniform, and then
either `stddev * (sqrt(2) * erf_inv(u))` (fp32, or rounded to bf16: the
reference's `normal_init`) or the Gumbel noise `-log(-log(u))`, every
fp32 operation rounded as XLA's CPU backend rounds it. Element i depends
only on (key, i), so a slice of a leaf is drawn alone.

What bounds it on an H100: the SMs' instruction issue. A full qwen3-8b
(8.19 B draws) writes 32.8 GB, 9.8 ms at 3.35 TB/s, while each draw runs
a few hundred instructions (Threefry's 20 rounds, the uniform, log1p and
erf_inv's polynomial). The kernel is one thread an element, straight-line
code, one coalesced store a thread.

`normal` and `gumbel` run their plain versions
(`ref.random_normal_ref`, `ref.random_gumbel_ref`, in slices of
`PLAIN_CHUNK` elements) for the CPU only; on CUDA they launch the kernel
or raise; on `meta` they return an empty tensor and draw nothing. Any
other device raises. Under an active op counter (`launch.opanalysis`) a
call records `work.threefry_work` instead of its own ops.
`normal_launches` and `gumbel_launches` count the kernel's launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import ref, work
from repro_torch.launch import opanalysis

PLAIN_CHUNK = 1 << 16      # elements of one plain-version slice (cache-sized)
DTYPES = (torch.float32, torch.bfloat16)

normal_launches = 0        # kernel launches (not plain-version calls)
gumbel_launches = 0


def _keys(keys) -> np.ndarray:
    keys = np.asarray(keys)
    if keys.dtype != np.uint32 or keys.ndim < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be a (..., 2) uint32 stack, got "
                         f"{keys.dtype} {keys.shape}")
    return keys


def _plain(fn, keys, n, offset, **kw):
    """The plain version on the CPU, a cache-sized slice at a time."""
    k = torch.from_numpy(keys.reshape(-1, 2).astype(np.int64))
    step = max(PLAIN_CHUNK // len(k), 1)
    parts = [fn(k, min(step, n - at), offset + at, **kw)
             for at in range(0, n, step)]
    flat = torch.cat(parts, dim=1) if parts else torch.empty((len(k), 0))
    return flat.reshape(*keys.shape[:-1], n)


def _library(name):
    from repro_torch.kernels import build
    fn = getattr(build.load("threefry"), name)
    if fn.argtypes is None:
        head = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong]
        fn.argtypes = head + ([ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p]
                              if name == "threefry_normal"
                              else [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _device_keys(keys, device) -> torch.Tensor:
    """The stack as (L, 2) uint32 words (an int32 tensor) on the card."""
    flat = np.ascontiguousarray(keys.reshape(-1, 2)).view(np.int32)
    return torch.from_numpy(flat).to(device)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {device}")
    return device


def normal(keys, n: int, *, stddev: float = 1.0, dtype=torch.float32,
           device, offset: int = 0) -> torch.Tensor:
    """`stddev * jax.random.normal(key, shape, float32)` cast to `dtype`,
    elements [offset, offset + n) of each key's flat draw: (*lead, n) for
    a (*lead, 2) uint32 stack of keys, on `device`."""
    global normal_launches
    keys = _keys(keys)
    device = _device(device)
    if dtype not in DTYPES:
        raise TypeError(f"the kernel writes {DTYPES}, not {dtype}")
    lead = keys.shape[:-1]
    n_bytes, ops = work.threefry_work(int(np.prod(lead)) * n,
                                      torch.finfo(dtype).bits // 8)
    with opanalysis.kernel("threefry_normal", ops, n_bytes):
        if device.type == "cpu":
            return _plain(ref.random_normal_ref, keys, n, offset,
                          stddev=stddev).to(dtype)
        out = torch.empty((*lead, n), dtype=dtype, device=device)
        if device.type == "meta" or out.numel() == 0:
            return out
        dk = _device_keys(keys, device)
        with torch.cuda.device(device):
            err = _library("threefry_normal")(
                dk.data_ptr(), dk.shape[0], n, offset,
                float(np.float32(stddev)), out.data_ptr(),
                int(dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_normal launch failed: CUDA error {err}")
    normal_launches += 1
    return out


def gumbel(keys, n: int, *, device, offset: int = 0) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, float32)`, elements [offset,
    offset + n) of each key's flat draw: (*lead, n) fp32 on `device`."""
    global gumbel_launches
    keys = _keys(keys)
    device = _device(device)
    lead = keys.shape[:-1]
    n_bytes, ops = work.threefry_work(int(np.prod(lead)) * n, 4,
                                      gumbel=True)
    with opanalysis.kernel("threefry_gumbel", ops, n_bytes):
        if device.type == "cpu":
            return _plain(ref.random_gumbel_ref, keys, n, offset)
        out = torch.empty((*lead, n), dtype=torch.float32, device=device)
        if device.type == "meta" or out.numel() == 0:
            return out
        dk = _device_keys(keys, device)
        with torch.cuda.device(device):
            err = _library("threefry_gumbel")(
                dk.data_ptr(), dk.shape[0], n, offset, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_gumbel launch failed: CUDA error {err}")
    gumbel_launches += 1
    return out


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` for one uint32[2] key over
    fp32 logits (..., V): argmax(logits + gumbel(key, logits.shape)) over
    the last axis, ties to the first index, on the logits' device."""
    g = gumbel(key, logits.numel(), device=logits.device)
    return torch.argmax(logits + g.view(logits.shape), dim=-1)
