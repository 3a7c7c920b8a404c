"""Step-atomic checkpoints in the reference's layout
(`repro/checkpoint/checkpointer.py`), for the port's trees, from one
process or from every rank of a joined mesh.

A step directory `step_<8 digits>` holds one `.npy` per leaf (its path
with "/" as "__") and `MANIFEST.json`, written LAST, with each leaf's
file, shape, dtype and the sha1 of its bytes, the step and `extra`.
Restore takes the newest step whose manifest and checksums hold (a torn
write falls back to the step before) and rebuilds `tree_like`'s
structure from the leaf paths; `keep_last` prunes older steps. So a
checkpoint the port writes restores in the reference and the other way
round. Leaves are saved from tensors (or arrays) and restored as CPU
tensors, or copied into `tree_like`'s own tensors (`into=True`).

A bf16 leaf is written as the reference writes one: numpy has no bf16, so
its `.npy` header says `<V2` (two raw bytes an element, the bf16 words),
its manifest dtype "bfloat16"; the reference's reader hands such a leaf
back as a `|V2` array, and this one restores it to bf16 by the manifest's
dtype, bit for bit.

`save(..., blocking=False)` snapshots what it writes to host numpy
arrays of their own (a copy, also of a CPU tensor, which training updates
in place after the call) and writes them in a background thread,
overlapping the next training steps; `wait()` joins it and raises what
it raised. A save first waits for the one before it, so two writers never
run at once. A stale `.tmp_step_*` of the same step (a writer that died)
is removed before a save writes there.

Across ranks (`mesh`, a joined `launch.mesh` mesh, one rank a card): the
files are the same, each leaf whole. Each rank writes its experts of
every expert leaf (`sharding.act.split_leaves`, (L, E, ...)): for each l
its experts [j E/tp, (j+1) E/tp) are one run of bytes at a fixed offset
after the header, which every rank writes alike; no rank gathers
another's experts. Each leaf held whole is written, and hashed from
memory, by one rank (`_owners`: the leaves by size over the ranks); each
expert leaf is hashed by one rank, from the file, once every rank has
written its runs. The background threads signal each other by marker
files in the `.tmp_step_*` directory, never by a collective (collectives
from two threads of one process group can deadlock or reorder); rank 0
writes the manifest and renames the directory once every rank has
signalled, and the other ranks' writers end when they see the step
committed, so `wait()` means committed on every rank. The main thread
agrees on what every rank decides: rank 0 says whether the step exists
(so a save returns the same value on every rank) and which steps a
restore tries; each rank checks the checksums of the leaves it owns, and
a step is taken only if every rank found its share valid, else every
rank falls back alike. A restoring rank reads its slab of each expert
leaf (`np.load(..., mmap_mode="r")`) and each leaf held whole.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.sharding import act as act_sharding
from repro_torch.tree import flatten, unflatten

BF16 = "bfloat16"
_CHUNK = 1 << 26           # bytes hashed or read at once
_POLL_S = 0.01
_WAIT_S = 3600.0           # a writer's wait for the other ranks' signals


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _host(leaf) -> np.ndarray:
    """A host copy of `leaf`'s bits: bf16 as its int16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.array(leaf)
    return a.view(np.int16) if a.dtype.name == BF16 else a


def _header(shape, dtype: str) -> bytes:
    """The `.npy` header `np.save` writes for an array of `shape` and
    `dtype` (the reference's `<V2` for bf16)."""
    descr = "<V2" if dtype == BF16 else \
        np.lib.format.dtype_to_descr(np.dtype(dtype))
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _sha1(a: np.ndarray) -> str:
    flat, h = _bytes(a), hashlib.sha1()
    for at in range(0, len(flat), _CHUNK):
        h.update(flat[at:at + _CHUNK])
    return h.hexdigest()


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A restored leaf's bits as a CPU tensor of `dtype` (a copy of a
    slice of a memory map)."""
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _owners(sizes: List[int], ranks: int) -> List[int]:
    """Each leaf's rank: the largest leaf first, each to the rank with the
    fewest bytes so far (the lowest such rank)."""
    load, out = [0] * ranks, [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(ranks), key=lambda r: (load[r], r))
        out[i] = r
        load[r] += sizes[i]
    return out


def _pwrite(fd: int, data: np.ndarray, offset: int) -> None:
    view = memoryview(_bytes(data))
    while len(view):
        n = os.pwrite(fd, view[:1 << 30], offset)
        view, offset = view[n:], offset + n


def _wait_for(paths, what: str) -> None:
    deadline = time.monotonic() + _WAIT_S
    while not all(p.exists() for p in paths):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: waited {_WAIT_S} s for "
                               f"{[str(p) for p in paths if not p.exists()]}")
        time.sleep(_POLL_S)


@dataclasses.dataclass
class _Leaf:
    """A leaf as the checkpoint holds it: whole `shape`; `split`: the
    ranks hold its experts along axis 1, `experts` of them each."""
    name: str
    shape: tuple
    dtype: str
    split: bool
    experts: int = 0

    @property
    def file(self) -> str:
        return self.name.replace("/", "__") + ".npy"

    @property
    def nbytes(self) -> int:
        n = 2 if self.dtype == BF16 else np.dtype(self.dtype).itemsize
        return n * int(np.prod(self.shape, dtype=np.int64))


@dataclasses.dataclass
class _Pending:
    thread: threading.Thread
    step: int
    error: List[BaseException]


class Checkpointer:
    def __init__(self, directory, keep_last: int = 3, mesh=None):
        """`mesh`: a joined mesh (1, n), this process one of its ranks
        (module docstring)."""
        if mesh is not None and not act_sharding.joined(mesh):
            raise ValueError("a Checkpointer across ranks takes a joined "
                             "mesh (launch.mesh.join_host_mesh)")
        if mesh is not None and mesh.size != mesh.tp_size:
            raise ValueError(f"mesh {mesh.shape}: only a (1, n) mesh")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.ranks = mesh.size if mesh is not None else 1
        self._pending: Optional[_Pending] = None
        # this rank's seconds and bytes of its last save and restore
        self.last_save: Dict[str, float] = {}
        self.last_restore: Dict[str, float] = {}

    # ------------------------------------------------------------- agree
    def _agree(self, value):
        """Rank 0's `value` on every rank (main thread only)."""
        if self.mesh is None:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.mesh.group)
        return box[0]

    def _everyone(self, ok: bool) -> bool:
        """Whether `ok` holds on every rank (main thread only)."""
        if self.mesh is None:
            return ok
        import torch.distributed as dist
        got = [None] * self.ranks
        dist.all_gather_object(got, ok, group=self.mesh.group)
        return all(got)

    def _plan(self, tree) -> List[_Leaf]:
        """The checkpoint's leaves from this rank's `tree`."""
        split = set(act_sharding.split_leaves(tree, self.mesh))
        out = []
        for name, leaf in flatten(tree):
            shape = tuple(leaf.shape)
            if name in split:
                out.append(_Leaf(name, (shape[0], shape[1] * self.ranks,
                                        *shape[2:]), _dtype_name(leaf),
                                 True, shape[1]))
            else:
                out.append(_Leaf(name, shape, _dtype_name(leaf), False))
        return out

    def _owner_of(self, plan: List[_Leaf]) -> Dict[str, int]:
        owners = _owners([leaf.nbytes for leaf in plan], self.ranks)
        return {leaf.name: r for leaf, r in zip(plan, owners)}

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None,
             blocking: bool = True) -> bool:
        """Returns True if the checkpoint was written (or enqueued),
        False if `step` already exists on disk and the save was skipped;
        the same on every rank."""
        self.wait()                                # never two writers racing
        tmp = self.dir / f".tmp_step_{step:08d}"
        exists = False
        if self.rank == 0:
            exists = step in self.steps()
            if not exists and tmp.exists():
                shutil.rmtree(tmp)                 # a dead writer's
        if self._agree(exists):
            return False                           # already committed
        t0 = time.perf_counter()
        plan = self._plan(tree)
        owner = self._owner_of(plan)
        mine = {name: _host(leaf) for (name, leaf), p in zip(flatten(tree),
                                                             plan)
                if p.split or owner[name] == self.rank}  # snapshot NOW
        self.last_save = {"snapshot_s": time.perf_counter() - t0,
                          "bytes": sum(a.nbytes for a in mine.values())}
        extra = dict(extra or {})

        def write():
            t1 = time.perf_counter()
            tmp.mkdir(parents=True, exist_ok=True)
            sums = {}
            for leaf in plan:
                a = mine.pop(leaf.name, None)
                if a is None:
                    continue
                header = _header(leaf.shape, leaf.dtype)
                if not leaf.split:
                    with open(tmp / leaf.file, "wb") as f:
                        f.write(header)
                        f.write(_bytes(a))
                    sums[leaf.name] = _sha1(a)
                    continue
                fd = os.open(tmp / leaf.file, os.O_WRONLY | os.O_CREAT,
                             0o644)
                try:
                    os.pwrite(fd, header, 0)
                    run = a[0].nbytes          # one l's experts of this rank
                    for layer in range(a.shape[0]):
                        _pwrite(fd, a[layer], len(header) + run * (
                            layer * self.ranks + self.rank))
                finally:
                    os.close(fd)
            self.last_save["write_s"] = time.perf_counter() - t1
            if self.mesh is not None:
                t2 = time.perf_counter()
                self._signal(tmp, "written", {})
                _wait_for([tmp / f"rank{r}.written"
                           for r in range(self.ranks)],
                          f"step {step}: the ranks' writes")
                for leaf in plan:
                    if leaf.split and owner[leaf.name] == self.rank:
                        sums[leaf.name] = self._file_sha1(tmp, leaf)
                self._signal(tmp, "hashed", sums)
                self.last_save["hash_s"] = time.perf_counter() - t2
            if self.rank == 0:
                self._commit(step, tmp, plan, sums, extra)
            else:
                _wait_for([self.dir / f"step_{step:08d}" / "MANIFEST.json"],
                          f"step {step}: rank 0's commit")
            self.last_save["commit_s"] = time.perf_counter() - t1

        if blocking:
            write()
        else:
            error: List[BaseException] = []

            def run():
                try:
                    write()
                except BaseException as e:    # raised again by wait()
                    error.append(e)
            t = threading.Thread(target=run, daemon=True)
            t.start()
            self._pending = _Pending(t, step, error)
        return True

    def _signal(self, tmp, what: str, sums: Dict[str, str]) -> None:
        """This rank's marker `rank<r>.<what>` (its sha1s), whole or
        absent: written aside, then renamed."""
        part = tmp / f"rank{self.rank}.{what}.part"
        part.write_text(json.dumps(sums))
        os.replace(part, tmp / f"rank{self.rank}.{what}")

    def _file_sha1(self, tmp, leaf: _Leaf) -> str:
        """The sha1 of an expert leaf's bytes as the ranks wrote them."""
        header, h = _header(leaf.shape, leaf.dtype), hashlib.sha1()
        path = tmp / leaf.file
        size = os.path.getsize(path)
        if size != len(header) + leaf.nbytes:
            raise IOError(f"{leaf.name}: {size} bytes on disk, want "
                          f"{len(header) + leaf.nbytes}")
        with open(path, "rb") as f:
            if f.read(len(header)) != header:
                raise IOError(f"{leaf.name}: another header on disk")
            while chunk := f.read(_CHUNK):
                h.update(chunk)
        return h.hexdigest()

    def _commit(self, step, tmp, plan, sums, extra) -> None:
        """Rank 0: the manifest (every rank's sha1s), LAST, then the
        rename into place."""
        if self.mesh is not None:
            markers = [tmp / f"rank{r}.hashed" for r in range(self.ranks)]
            _wait_for(markers, f"step {step}: the ranks' sha1s")
            for m in markers:
                sums.update(json.loads(m.read_text()))
            for m in tmp.glob("rank*"):
                m.unlink()
        manifest = {"step": step, "extra": extra, "arrays": {},
                    "time": time.time()}
        for leaf in plan:
            manifest["arrays"][leaf.name] = {
                "file": leaf.file, "shape": list(leaf.shape),
                "dtype": leaf.dtype, "sha1": sums[leaf.name]}
        # manifest LAST = commit point
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        d = self.dir / f"step_{step:08d}"
        if d.exists():                             # torn: no manifest
            shutil.rmtree(d)
        tmp.rename(d)
        self._prune()

    def wait(self):
        """Join the save in flight, if any; raise what its writer raised."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.thread.join()
            if pending.error:
                raise pending.error[0]

    def next_step(self, hint: int = 0) -> int:
        """Smallest step >= `hint` that is strictly newer than every step
        on disk or in flight: safe to save() (no silent skip-existing)
        and the newest once saved, so restore() picks it up."""
        pending = [self._pending.step + 1] if self._pending else []
        return max([hint] + pending + [s + 1 for s in self.steps()])

    # ------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for d in sorted(self.dir.glob("step_*")):
            if (d / "MANIFEST.json").exists():
                out.append(int(d.name.split("_")[1]))
        return out

    def restore(self, tree_like, step: Optional[int] = None,
                verify: bool = True, into: bool = False):
        """Returns (tree, step, extra) from the newest valid checkpoint
        (or `step`), leaves as CPU tensors; with `into`, each restored leaf
        is copied into `tree_like`'s tensor, which must have its shape
        (this rank's slab of an expert leaf) and dtype, and the tree
        returned is `tree_like`. Raises FileNotFoundError if none exists,
        on every rank alike."""
        t0 = time.perf_counter()
        cands = self._agree(self.steps() if step is None else [step])
        plan = self._plan(tree_like)
        for s in sorted(cands, reverse=True):
            try:
                leaves, extra = self._read(s, plan, verify)
                ok = True
            except Exception:
                if step is not None and self.mesh is None:
                    raise
                ok = False
            if not self._everyone(ok):
                if step is not None:
                    raise IOError(f"step {s} is not valid on every rank")
                continue                            # torn write: fall back
            out = unflatten(tree_like, leaves)
            if into:
                for name, leaf in flatten(tree_like):
                    got = leaves[name]
                    if leaf.shape != got.shape or leaf.dtype != got.dtype:
                        raise ValueError(f"{name}: {got.dtype} "
                                         f"{tuple(got.shape)} into "
                                         f"{leaf.dtype} {tuple(leaf.shape)}")
                    leaf.copy_(got)
                out = tree_like
            self.last_restore = {
                "restore_s": time.perf_counter() - t0,
                "bytes": sum(t.numel() * t.element_size()
                             for t in leaves.values())}
            return out, s, extra
        raise FileNotFoundError(f"no valid checkpoint under {self.dir}")

    def _read(self, s: int, plan: List[_Leaf], verify: bool):
        """This rank's leaves of step `s` (its slab of each expert leaf)
        as CPU tensors, and the step's `extra`; the checksums of the
        leaves this rank owns checked. Raises on anything torn."""
        d = self.dir / f"step_{s:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        arrays = manifest["arrays"]
        missing = [leaf.name for leaf in plan if leaf.name not in arrays]
        if missing:
            raise IOError(f"step {s} lacks {missing[:4]}")
        on_disk = [_Leaf(leaf.name, tuple(arrays[leaf.name]["shape"]),
                         arrays[leaf.name]["dtype"], leaf.split,
                         leaf.experts) for leaf in plan]
        owner = self._owner_of(on_disk)
        leaves = {}
        for want, leaf in zip(plan, on_disk):
            meta = arrays[leaf.name]
            if leaf.split and leaf.shape != want.shape:
                raise IOError(f"experts of {leaf.name}: {leaf.shape} on "
                              f"disk, {want.shape} on {self.ranks} ranks")
            a = np.load(d / meta["file"],
                        mmap_mode="r" if leaf.split else None)
            if list(a.shape) != list(meta["shape"]):
                raise IOError(f"shape mismatch: {leaf.name}")
            if verify and owner[leaf.name] == self.rank and \
                    _sha1(a) != meta["sha1"]:
                raise IOError(f"checksum mismatch: {leaf.name}")
            if leaf.split:
                lo = self.rank * leaf.experts
                a = a[:, lo:lo + leaf.experts]
            leaves[leaf.name] = _tensor(a, leaf.dtype)
        return leaves, manifest["extra"]

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            d = self.dir / f"step_{s:08d}"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
