"""The reference's checkpoint layout, read without jax.

A checkpoint step directory holds one `.npy` per pytree leaf and a
`MANIFEST.json` written last, mapping each leaf path ("actor/enc/conv1/wr")
to its file, shape, dtype and the sha1 of `arr.tobytes()`
(`repro/checkpoint/checkpointer.py`). `load_reference_checkpoint` checks
every leaf against its manifest entry and returns the tree as nested
dicts of numpy arrays; `params_from_numpy` turns such a tree (or the
reference agent's `actor`/`critic` converted with `np.asarray`) into the
state dicts of the port's actor and critic. `agent_state_from_numpy`
turns a whole reference agent tree `{actor, critic, aopt, copt}` into the
port's agent state (`checkpoint.agent_io`), optimizer moments and steps
included, and `agent_state_to_numpy` goes the other way; leaf names are
the reference's on both sides. A list in the reference's tree (the
QueryFormer's layers) becomes the dict keyed "0", "1", ... that the
port's `nn.ModuleList` gives (`repro_torch.tree`).
`lm_params_from_numpy` turns `repro.models.lm.init_params`'s pytree, as
numpy arrays, into the parameters of the port's `models.lm`: the same
nesting, leaves stacked on the same superblock axis.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Dict

import numpy as np
import torch

from repro_torch.models.moe import EXPERT_LEAVES
from repro_torch.tree import children, is_node, tree_map


def load_reference_checkpoint(directory) -> Dict:
    """One step directory -> nested dict of numpy arrays, a bf16 leaf
    (manifest dtype "bfloat16") as the `|V2` words its `.npy` holds, as
    the reference's reader gives it. Raises IOError on a leaf whose bytes,
    shape or dtype disagree with the manifest."""
    d = pathlib.Path(directory)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    tree: Dict = {}
    for name, meta in manifest["arrays"].items():
        arr = np.load(d / meta["file"])
        if hashlib.sha1(arr.tobytes()).hexdigest() != meta["sha1"]:
            raise IOError(f"checksum mismatch: {name}")
        dtype = "|V2" if meta["dtype"] == "bfloat16" else meta["dtype"]
        if list(arr.shape) != list(meta["shape"]) or \
                arr.dtype != np.dtype(dtype):
            raise IOError(f"shape/dtype mismatch: {name}")
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in children(tree).items():
        if is_node(v):
            out.update(_state_dict(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def params_from_numpy(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"actor": {...}, "critic": {...}} nested numpy trees (extra keys
    such as optimizer states are ignored) -> {"actor": state_dict,
    "critic": state_dict} for `AqoraAgent.load_params`."""
    return {net: _state_dict(tree[net]) for net in ("actor", "critic")}


def lm_params_from_numpy(tree, device, mesh=None) -> Dict:
    """A reference LM parameter pytree (`repro.models.lm.init_params`,
    each leaf converted with `np.asarray`) -> the port's LM parameters on
    `device`, leaf for leaf, dtypes kept (a bf16 leaf arrives as numpy's
    ml_dtypes bfloat16 and is carried across bit for bit). With a `mesh`
    (`launch.mesh`), each expert leaf is cut to the rank's experts [j
    E/tp, (j+1) E/tp), j = mesh.tp_rank, as `lm.init_params(...,
    mesh=)` draws them."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a.view(np.int16)))
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a)).to(device)

    def convert(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = convert(v)
                continue
            if mesh is not None and k in EXPERT_LEAVES:  # (L, E, ...)
                v = np.asarray(v)
                El = v.shape[1] // mesh.tp_size
                v = v[:, mesh.tp_rank * El:(mesh.tp_rank + 1) * El]
            out[k] = leaf(v)
        return out
    return convert(tree)


def agent_state_from_numpy(tree) -> Dict:
    """{"actor", "critic", "aopt", "copt"} nested numpy trees (a
    reference checkpoint or `agent_state` converted with `np.asarray`) ->
    the port's agent state, CPU tensors (each leaf copied)."""
    return {k: tree_map(lambda x: torch.from_numpy(np.array(x)), tree[k])
            for k in ("actor", "critic", "aopt", "copt")}


def agent_state_to_numpy(state) -> Dict:
    """The port's agent state -> nested numpy trees with the reference's
    leaf names, dtypes (float32 leaves, int32 steps) and shapes."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
