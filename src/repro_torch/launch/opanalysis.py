"""The port's counterpart of the reference's `launch/hloanalysis.py`: a
count of FLOPs, bytes and live memory, op by op, of a program as it runs.

The reference reads its costs from the optimized HLO text, multiplying
each computation by its trip count. The port has no HLO: `OpCounter` is a
`TorchDispatchMode` that sees every aten op a program dispatches, on the
`meta` device (no data, no time: a dry run) as on `cuda` or `cpu`, under
the reference's conventions (`hloanalysis.py:1-17`):

    flops  — matmuls exact at 2·M·N·K (mm, addmm, bmm, baddbmm);
             elementwise ops and reductions at 1 an output element;
             views, reshapes, copies, fills and indexing at 0
    bytes  — operands + outputs at each op; views and reshapes are free
             (an op whose output aliases its input moves nothing), and a
             fresh allocation (empty, empty_like) writes nothing

A Python loop of T layers dispatches its ops T times and counts T times,
which is what the reference's trip-count logic exists for.

Peak live bytes: every storage an op creates is added to the live total
when it appears and taken off when it is freed (a weak reference to the
storage), so saved activations count while autograd holds them; the
caller registers the program's inputs (`track`). This is the tensors'
own bytes, not the CUDA caching allocator's rounded blocks.

The kernels: a hand-written kernel is a ctypes call that no dispatch mode
sees. Each kernel wrapper runs under `kernel(name, flops, bytes)`, which
pauses the count of the wrapper's own ops (its plain version on the CPU,
its empty output on `meta`, its output allocation on `cuda`) and records
the kernel's work (`kernels.work`) once. So a count on any of the three
devices is the count of the program the card runs.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# the active counters (outermost first); the autograd engine's threads
# see them too, which a thread-local would not
_ACTIVE: List["OpCounter"] = []

_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default}
_FREE = {  # no flops: creation, fills, copies and casts, indexing, selection
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "fill_", "zero_", "copy_",
    "_to_copy", "clone", "cat", "stack", "index", "index_select", "gather",
    "scatter", "index_put", "index_put_", "select_backward",
    "slice_backward", "arange", "constant_pad_nd", "scalar_tensor",
    "_local_scalar_dense", "masked_fill", "topk", "where"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
_RESHAPE = {"_unsafe_view", "alias", "detach", "lift_fresh"}


def tensors(tree) -> list:
    """The tensors among a tree's leaves."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args, out) -> int:
    a, b = (args[1], args[2]) if func in (aten.addmm.default,
                                          aten.baddbmm.default) \
        else (args[0], args[1])
    return 2 * out.numel() * a.shape[-1]


class OpCounter(TorchDispatchMode):
    """Counts every aten op run under it: `flops`, `bytes`, `ops`, the live
    and `peak_live_bytes`, and `kernels`, one record a kernel call.

        with OpCounter() as c:
            c.track(params, batch)
            step(params, batch)
        c.summary()
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.by_op: Dict[str, List[float]] = {}
        self.kernels: List[dict] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._seen = weakref.WeakKeyDictionary()
        self._paused = 0

    # ------------------------------------------------------------- memory
    def track(self, *trees) -> int:
        """Add the storages of every tensor in `trees` to the live bytes
        (the program's arguments). Returns the bytes added."""
        before = self.live_bytes
        for t in tensors(trees):
            self._add_storage(t)
        return self.live_bytes - before

    def _add_storage(self, t: torch.Tensor):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.live_bytes -= n

    # ------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        outs = tensors(out)
        for t in outs:
            self._add_storage(t)
        name = func.overloadpacket.__name__
        if not outs and name.endswith("_"):
            outs = tensors(args[:1])       # in place (`_foreach_*_`)
        view = name in _RESHAPE or _is_view(func)
        moved = 0 if view or name in _ALLOC else (
            sum(_nbytes(t) for t in tensors((args, kwargs)))
            + sum(_nbytes(t) for t in outs))
        if func in _MATMUL:
            flops = _matmul_flops(func, args, outs[0])
        elif view or name in _FREE:
            flops = 0
        else:
            flops = sum(t.numel() for t in outs)
        self.ops += 1
        self.flops += flops
        self.bytes += moved
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved
        return out

    # ------------------------------------------------------------- kernels
    def add_kernel(self, name: str, flops: float, n_bytes: float):
        self.kernels.append({"name": name, "flops": flops, "bytes": n_bytes})
        self.flops += flops
        self.bytes += n_bytes

    def kernel_totals(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for k in self.kernels:
            r = out.setdefault(k["name"], {"calls": 0, "flops": 0,
                                           "bytes": 0})
            r["calls"] += 1
            r["flops"] += k["flops"]
            r["bytes"] += k["bytes"]
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "peak_live_bytes": self.peak_live_bytes,
                "kernels": self.kernel_totals()}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)


def _is_view(func) -> bool:
    """An op whose output aliases an input without writing it."""
    return any(a.alias_info is not None and not a.alias_info.is_write
               for a in func._schema.returns)


def active() -> Optional[OpCounter]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def kernel(name: str, flops: float, n_bytes: float):
    """Around a kernel wrapper's own work: with a counter active, its ops
    are not counted and the kernel's flops and bytes are recorded once;
    without one, nothing."""
    c = active()
    if c is None:
        yield
        return
    c._paused += 1
    try:
        yield
    finally:
        c._paused -= 1
    c.add_kernel(name, flops, n_bytes)
