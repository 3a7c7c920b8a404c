"""Meshes, as the reference's `repro.launch.mesh`: axis names and sizes,
and, for a mesh that a program runs across, the process group that spans
it and this process's place in it.

A descriptor (no group) names a layout: the dry run on one card names
the production layout it plans for (`make_production_mesh`), and
`make_host_mesh` describes the CUDA devices of this host. A joined mesh
(`join_host_mesh`) is the host mesh (1, n) as seen by one of its n
processes, one rank a card: the experts of an MoE layer are split over
its "model" axis and summed by `torch.distributed.all_reduce` over its
group (`models/moe.py`). `spawn_ranks` starts the n processes, each
joined as its rank, and collects what each returns.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[str, ...] = ()     # the devices it names, if any
    # a joined mesh: the torch.distributed group spanning it (None for a
    # descriptor), this process's rank in it (the flat index of its
    # coordinates) and its device
    group: Any = dataclasses.field(default=None, compare=False)
    rank: int = 0
    device: Optional[str] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)

    @property
    def tp_size(self) -> int:
        """The size of the last ("model") axis."""
        return self.shape[-1]

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the last ("model") axis."""
        return self.rank % self.shape[-1]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod.

    Axes: data (FSDP/batch), model (TP/expert). The multi-pod mesh adds a
    leading pure-DP "pod" axis: parameters are never sharded across it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh() -> Mesh:
    """(1, n) over the CUDA devices there are; (1, 1) over the CPU where
    there is none."""
    import torch
    n = torch.cuda.device_count()
    devices = tuple(f"cuda:{i}" for i in range(n)) if n else ("cpu",)
    return Mesh(("data", "model"), (1, len(devices)), devices)


def join_host_mesh(rank: int, world: int, store_dir: str, *,
                   backend: str = "nccl", device: Optional[str] = None,
                   timeout_s: float = 300.0) -> Mesh:
    """Join the host mesh (1, world) as `rank`: a process group over a
    `FileStore` in `store_dir` (the same directory in every rank).
    "nccl" takes one card a rank (`device` cuda:rank by default, set as
    the group's `device_id`); "gloo" takes any `device`, several ranks to
    a card or the CPU. A collective that waits longer than `timeout_s`
    raises."""
    import torch
    import torch.distributed as dist
    device = device or f"cuda:{rank}"
    kw = {}
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
        if backend == "nccl":
            kw["device_id"] = torch.device(device)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return Mesh(("data", "model"), (1, world), group=dist.group.WORLD,
                rank=rank, device=device)


def leave(mesh: Mesh) -> None:
    """Destroy a joined mesh's process group."""
    import torch.distributed as dist
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world, store_dir, backend, device, args, out):
    """One rank: join, run fn(mesh, *args), write its result (or its
    traceback) to `out`."""
    try:
        mesh = join_host_mesh(rank, world, store_dir, backend=backend,
                              device=device)
        try:
            result = ("ok", fn(mesh, *args))
        finally:
            leave(mesh)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise
    with open(out, "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                backend: str = "nccl",
                devices: Optional[Sequence[str]] = None,
                timeout_s: float = 900.0) -> list:
    """Start `world` processes (spawned), rank r joined as `join_host_mesh`
    on `devices[r]` (cuda:r by default), each running fn(mesh, *args);
    `fn` and `args` must pickle. Returns the ranks' results in rank
    order. Raises when a rank fails (after stopping the others, which may
    wait in a collective for it) or when the ranks outlast `timeout_s`."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    devices = list(devices or [f"cuda:{r}" for r in range(world)])
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, tmp, backend, devices[r], tuple(args), outs[r]))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results, failed = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            status, value = "missing", None
            if os.path.exists(out):
                with open(out, "rb") as f:
                    status, value = pickle.load(f)
            if status != "ok":
                failed.append(f"rank {r} (exit {p.exitcode}): "
                              f"{value or status}")
            results.append(value)
    if failed:
        raise RuntimeError(f"{len(failed)} of {world} ranks failed "
                           f"(timeout {timeout_s} s):\n" + "\n".join(failed))
    return results
