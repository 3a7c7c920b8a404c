"""The ranks of `tests/test_torch_shard_ckpt.py`: reduced dbrx-132b trained
by `launch.train.train` on a joined mesh with checkpoints, restored, and
a reference checkpoint read on the ranks. torch and the port only (the
ranks are spawned: `launch.mesh.spawn_ranks` imports this module in each).
"""
import contextlib
import dataclasses
import pathlib
import shutil
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import registry
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten

ARCH = "dbrx-132b"
STEPS, EVERY = 3, 2
REF_WAIT_S = 300
KW = dict(smoke=True, steps=STEPS, global_batch=2, seq_len=8, log_every=0,
          ckpt_every=EVERY)


@contextlib.contextmanager
def param_dtype(dtype):
    """`registry.reduced` giving parameters and AdamW moments in `dtype`
    (bf16 stands in for jamba's leaves)."""
    reduced = registry.reduced
    registry.reduced = lambda cfg: dataclasses.replace(
        reduced(cfg), param_dtype=dtype, opt_moment_dtype=dtype)
    try:
        yield
    finally:
        registry.reduced = reduced


def bits(tree):
    """{path: numpy array} of a tree's leaves, bf16 as uint16 words."""
    out = {}
    for path, t in flatten(tree):
        if t.dtype == torch.bfloat16:
            out[path] = t.view(torch.int16).numpy().view(np.uint16).copy()
        else:
            out[path] = t.numpy().copy()
    return out


def rank_main(mesh, root, dtypes):
    """Per dtype: run "a" (STEPS steps, a checkpoint every EVERY and at
    the end), run "b" restored from a copy of "a" whose last step has no
    manifest, the last step of "a" with one expert leaf's bytes flipped
    (dir "c") restored, and the reference's checkpoint ("ref"), which the
    test process writes meanwhile, restored.
    Returns {dtype: what each gave}."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {}
    for dtype in dtypes:
        d = pathlib.Path(root) / dtype
        with param_dtype(dtype):
            params, losses = ttrain.train(ARCH, mesh=mesh,
                                          ckpt_dir=str(d / "a"), **KW)
            if mesh.rank == 0:
                shutil.copytree(d / "a", d / "b")
                (d / "b" / f"step_{STEPS:08d}" / "MANIFEST.json").unlink()
                shutil.copytree(d / "a", d / "c")
                f = d / "c" / f"step_{STEPS:08d}" / \
                    "0__stack__layer0__ffn__moe_wu.npy"
                raw = bytearray(f.read_bytes())
                raw[-1] ^= 0xFF                 # the last rank's slab
                f.write_bytes(bytes(raw))
            dist.barrier(group=mesh.group)
            resumed, tail = ttrain.train(ARCH, mesh=mesh,
                                         ckpt_dir=str(d / "b"),
                                         restore=True, **KW)
            like = [params, adamw_init(params, params["embed"].dtype)]
            _, corrupt_step, _ = Checkpointer(d / "c", mesh=mesh).restore(
                like)
            ref_ckpt = Checkpointer(d / "ref", mesh=mesh)
            deadline = time.monotonic() + REF_WAIT_S
            while not ref_ckpt.steps() and time.monotonic() < deadline:
                time.sleep(0.1)         # the test process is writing it
            ref, ref_step, ref_extra = ref_ckpt.restore(like)
        out[dtype] = {"losses": losses, "tail": tail,
                      "params": bits(params), "resumed": bits(resumed),
                      "corrupt_step": corrupt_step, "ref": bits(ref),
                      "ref_step": ref_step, "ref_extra": ref_extra}
    return out
