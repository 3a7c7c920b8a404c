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
"""
from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Dict

import numpy as np
import torch

from repro_torch.tree import children, is_node, tree_map


def load_reference_checkpoint(directory) -> Dict:
    """One step directory -> nested dict of numpy arrays. Raises IOError
    on a leaf whose bytes, shape or dtype disagree with the manifest."""
    d = pathlib.Path(directory)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    tree: Dict = {}
    for name, meta in manifest["arrays"].items():
        arr = np.load(d / meta["file"])
        if hashlib.sha1(arr.tobytes()).hexdigest() != meta["sha1"]:
            raise IOError(f"checksum mismatch: {name}")
        if list(arr.shape) != list(meta["shape"]) or \
                str(arr.dtype) != meta["dtype"]:
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
