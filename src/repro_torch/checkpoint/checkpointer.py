"""Step-atomic checkpoints in the reference's layout
(`repro/checkpoint/checkpointer.py`), for the port's trees.

A step directory `step_<8 digits>` holds one `.npy` per leaf (its path
with "/" as "__") and `MANIFEST.json`, written LAST, with each leaf's
file, shape, dtype and the sha1 of its bytes, the step and `extra`.
Restore takes the newest step whose manifest and checksums hold (a torn
write falls back to the step before) and rebuilds `tree_like`'s
structure from the leaf paths; `keep_last` prunes older steps. So a
checkpoint the port writes restores in the reference and the other way
round. Leaves are saved from tensors (or arrays) and restored as CPU
tensors.

`save(..., blocking=False)` snapshots every leaf to a host numpy array of
its own (a copy, also of a CPU tensor, which training updates in place
after the call) and writes them in a background thread, overlapping the
next training steps; `wait()` joins it. A save first waits for the one
before it, so two writers never run at once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _flatten(tree) -> List[Tuple[str, np.ndarray]]:
    """(path, host array) per leaf, each array a copy of its own."""
    return [(name, leaf.detach().to("cpu", copy=True).numpy()
             if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for name, leaf in flatten(tree)]


@dataclasses.dataclass
class _Pending:
    thread: threading.Thread
    step: int


class Checkpointer:
    def __init__(self, directory, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._pending: Optional[_Pending] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None,
             blocking: bool = True) -> bool:
        """Returns True if the checkpoint was written (or enqueued),
        False if `step` already exists on disk and the save was skipped."""
        self.wait()                                # never two writers racing
        if step in self.steps():
            return False                           # already committed
        leaves = _flatten(tree)                    # snapshot NOW (host copy)
        extra = dict(extra or {})

        def write():
            d = self.dir / f"step_{step:08d}"
            tmp = self.dir / f".tmp_step_{step:08d}"
            tmp.mkdir(parents=True, exist_ok=True)
            manifest = {"step": step, "extra": extra, "arrays": {},
                        "time": time.time()}
            for name, arr in leaves:
                fn = name.replace("/", "__") + ".npy"
                np.save(tmp / fn, arr)
                manifest["arrays"][name] = {
                    "file": fn, "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
                }
            # manifest LAST = commit point
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
            tmp.rename(d)
            self._prune()

        if blocking:
            write()
        else:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._pending = _Pending(t, step)
        return True

    def wait(self):
        """Join the save in flight, if any."""
        if self._pending is not None:
            self._pending.thread.join()
            self._pending = None

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
                verify: bool = True):
        """Returns (tree, step, extra) from the newest valid checkpoint
        (or `step`), leaves as CPU tensors. Raises FileNotFoundError if
        none exists."""
        cands = self.steps() if step is None else [step]
        for s in sorted(cands, reverse=True):
            d = self.dir / f"step_{s:08d}"
            try:
                manifest = json.loads((d / "MANIFEST.json").read_text())
                leaves = {}
                for name, meta in manifest["arrays"].items():
                    arr = np.load(d / meta["file"])
                    if verify and hashlib.sha1(
                            arr.tobytes()).hexdigest() != meta["sha1"]:
                        raise IOError(f"checksum mismatch: {name}")
                    leaves[name] = torch.from_numpy(arr)
                return unflatten(tree_like, leaves), s, manifest["extra"]
            except Exception:
                if step is not None:
                    raise
                continue                            # torn write: fall back
        raise FileNotFoundError(f"no valid checkpoint under {self.dir}")

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            d = self.dir / f"step_{s:08d}"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
