"""Sharding rule engine: parameter tree -> partition-spec tree.

The reference's `repro.sharding.rules`, over the port's dict trees
(`repro_torch.tree`) and with `P` standing in for jax's `PartitionSpec`:
the same Megatron/MaxText-style named rules with divisibility fallback,
so that one set of rules serves every assigned architecture (head counts
from 6 to 64, vocabs from 51865 to 256000) without per-arch hand specs:

  * COL weights (qkv/gate/up/router/in-proj):   in -> FSDP axis, out -> TP axis
  * ROW weights (o/down/out-proj):              in -> TP axis,   out -> FSDP axis
  * expert weights (E, D, F):                   E  -> TP axis (expert parallel),
                                                largest remaining divisible -> FSDP
  * embed (V, D): V -> TP (vocab-parallel logits), D -> FSDP; non-divisible
    vocabs (73448, 51865) fall back to D -> TP.
  * norms / biases / scalars / small state: replicated.

Params are stacked on a leading superblock axis which is never sharded.
Parameters are *never* sharded across the "pod" axis: pods are pure
data-parallel replicas, so every rule here names only "data"/"model".

If a dim is not divisible by its mesh axis, that assignment is dropped
(never an error): whisper-tiny ends up mostly replicated, which is
correct: it is 4 layers of d=384.

Nothing here places a tensor: the port runs on one card, and these specs
describe the layout a dry run (`launch.dryrun`) plans for. `MeshAxes`
holds axis names and sizes, with no devices.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from repro_torch.tree import is_node, children


class P(tuple):
    """A partition spec: one entry a tensor dim, each an axis name, a
    tuple of axis names or None (replicated), as jax's `PartitionSpec`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Axis names + sizes of the active mesh, plus role mapping."""
    data: str = "data"            # FSDP / batch axis
    model: str = "model"          # TP / expert axis
    pod: Optional[str] = None     # pure-DP outer axis (multi-pod)
    sizes: Tuple[Tuple[str, int], ...] = (("data", 16), ("model", 16))

    def size(self, name: Optional[str]) -> int:
        if name is None:
            return 1
        return dict(self.sizes)[name]

    @property
    def dp_axes(self):
        """Axes for sharding the batch dim (pod-major)."""
        return (self.pod, self.data) if self.pod else (self.data,)

    @property
    def dp_size(self) -> int:
        return self.size(self.pod) * self.size(self.data)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        """From a `launch.mesh.Mesh` descriptor."""
        names = tuple(mesh.axis_names)
        sizes = tuple(zip(names, mesh.shape))
        if "pod" in names:
            return cls(pod="pod", sizes=sizes)
        return cls(sizes=sizes)


# --------------------------------------------------------------- param rules
# leaf-name patterns -> kind
_ROW = re.compile(r"^(wo|w_down|mamba_out|mamba_dtproj)$")
_COL = re.compile(r"^(wq|wk|wv|w_gate|w_up|wq_a|wq_b|wkv_a|wkv_b|mamba_in|"
                  r"mamba_xproj|lm_head|router)$")
_EXPERT = re.compile(r"^moe_w[gud]$")
_BIAS = re.compile(r".*_bias$")


def _fit(dim: int, axis: Optional[str], axes: MeshAxes) -> Optional[str]:
    """Return axis if dim divides evenly over it, else None."""
    if axis is None or dim % axes.size(axis) != 0:
        return None
    return axis


def _dense_spec(shape, axes: MeshAxes, *, row: bool, skip_leading: int):
    """2D dense weight (possibly with leading stack axes)."""
    spec = [None] * len(shape)
    i_in, i_out = skip_leading, len(shape) - 1
    in_ax, out_ax = ((axes.model, axes.data) if row else (axes.data, axes.model))
    spec[i_in] = _fit(shape[i_in], in_ax, axes)
    spec[i_out] = _fit(shape[i_out], out_ax, axes)
    if spec[i_in] is not None and spec[i_in] == spec[i_out]:
        spec[i_out] = None
    return P(*spec)


def _expert_spec(shape, axes: MeshAxes, skip_leading: int):
    """(..., E, D, F): experts -> model, largest remaining divisible -> data."""
    spec = [None] * len(shape)
    e = skip_leading
    spec[e] = _fit(shape[e], axes.model, axes)
    rest = list(range(e + 1, len(shape)))
    rest.sort(key=lambda i: -shape[i])
    for i in rest:
        if _fit(shape[i], axes.data, axes):
            spec[i] = axes.data
            break
    return P(*spec)


def _embed_spec(shape, axes: MeshAxes):
    V, D = shape
    v_ax = _fit(V, axes.model, axes)
    d_ax = _fit(D, axes.data, axes)
    if v_ax is None:                       # odd vocab: TP the feature dim
        v_ax, d_ax = _fit(V, axes.data, axes), _fit(D, axes.model, axes)
    return P(v_ax, d_ax)


def _leaf_spec(path, leaf, axes: MeshAxes):
    name = path[-1] if path else ""
    shape = tuple(leaf.shape)
    # leading superblock stack axis on everything under "stack"
    skip = 1 if (len(path) >= 2 and path[0] == "stack") else 0
    if name == "embed":
        return _embed_spec(shape, axes)
    if name == "pos_embed":
        return P(*([None] * len(shape)))
    if _EXPERT.match(name):
        return _expert_spec(shape, axes, skip)
    if _ROW.match(name):
        return _dense_spec(shape, axes, row=True, skip_leading=skip)
    if _COL.match(name):
        return _dense_spec(shape, axes, row=False, skip_leading=skip)
    if _BIAS.match(name) or len(shape) - skip <= 1:
        return P(*([None] * len(shape)))   # norms / biases / scalars: replicate
    if name == "mamba_A_log":              # (di, N): di -> model
        spec = [None] * len(shape)
        spec[skip] = _fit(shape[skip], axes.model, axes)
        return P(*spec)
    if name == "mamba_conv_w":             # (W, di): di -> model
        spec = [None] * len(shape)
        spec[-1] = _fit(shape[-1], axes.model, axes)
        return P(*spec)
    # default: largest axis -> data if divisible
    spec = [None] * len(shape)
    dims = sorted(range(skip, len(shape)), key=lambda i: -shape[i])
    for i in dims:
        if _fit(shape[i], axes.data, axes):
            spec[i] = axes.data
            break
    return P(*spec)


def map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a tree's leaves; path is the tuple of keys."""
    if not is_node(tree):
        return fn(path, tree)
    return {k: map_with_path(fn, v, path + (str(k),))
            for k, v in children(tree).items()}


def param_specs(params, axes: MeshAxes):
    """Spec tree matching a params (or opt-state) tree. Works on tensors
    of any device, `meta` included: only shapes are read."""
    return map_with_path(lambda path, leaf: _leaf_spec(path, leaf, axes),
                         params)


# --------------------------------------------------------------- data rules
def batch_specs(batch, axes: MeshAxes):
    """Shard dim 0 (global batch) over (pod, data) when divisible; a batch of
    1 (long_500k) falls back to sequence sharding over data."""
    def leaf(_, x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        if len(shape) == 0:
            return P()
        if shape[0] % axes.dp_size == 0:
            spec[0] = axes.dp_axes if axes.pod else axes.data
        elif len(shape) > 1 and shape[1] % axes.dp_size == 0:
            spec[1] = axes.dp_axes if axes.pod else axes.data
        return P(*spec)
    return map_with_path(leaf, batch)


def cache_specs(cache, axes: MeshAxes, kv_seq: bool = False):
    """kv_seq=True: prefer sharding the KV sequence axis over the model
    axis (flash-decoding style) instead of heads/head_dim: head_dim is a
    CONTRACTING dim in attention scores, so sharding it forces a per-layer
    all-reduce of the (B,H,1,S) score tensor; sequence sharding reduces the
    cross-shard exchange to softmax stats."""
    return _cache_specs(cache, axes, kv_seq)


def _cache_specs(cache, axes: MeshAxes, kv_seq: bool = False):
    """Decode-cache sharding. Entries are stacked (n_superblocks, B, ...):

      k/v/ck/cv (S, B, T, K, hd): B -> dp if divisible, else T (seq) -> dp
        (flash-decoding-style KV sequence sharding for batch-1 long context);
        K heads -> model if divisible, else head_dim -> model, else T -> model.
      ckv/krope (MLA latents) (S, B, T, r): B -> dp else T -> dp; r -> model.
      conv/ssm (mamba): d_inner -> model, B -> dp.
      pos write heads: replicated.
    """
    def leaf_spec(path, x):
        name = path[-1]
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        if name == "pos" or len(shape) <= 1:
            return P(*spec)
        dp = axes.dp_axes if axes.pod else axes.data
        B = shape[1]
        used_dp_on_seq = False
        if B % axes.dp_size == 0 and B > 1:
            spec[1] = dp
        elif len(shape) > 2 and shape[2] % axes.dp_size == 0:
            spec[2] = dp                                  # seq-shard the cache
            used_dp_on_seq = True
        if name in ("conv", "ssm"):    # conv:(S,B,W-1,di) ssm:(S,B,di,N)
            i = len(shape) - 2 if name == "ssm" else len(shape) - 1
            if spec[i] is None and shape[i] % axes.size(axes.model) == 0:
                spec[i] = axes.model
            return P(*spec)
        if name in ("ckv", "krope"):
            i = len(shape) - 1
            if shape[i] % axes.size(axes.model) == 0:
                spec[i] = axes.model
            return P(*spec)
        # attention k/v/ck/cv: (S, B, T, K, hd): KV heads if divisible,
        # else the SEQUENCE axis (flash-decoding), else head_dim as the
        # last resort.
        K_i, hd_i, T_i = len(shape) - 2, len(shape) - 1, 2
        if (kv_seq and not used_dp_on_seq
                and shape[T_i] % axes.size(axes.model) == 0):
            spec[T_i] = axes.model
        elif not kv_seq and shape[K_i] % axes.size(axes.model) == 0:
            spec[K_i] = axes.model
        elif not used_dp_on_seq and shape[T_i] % axes.size(axes.model) == 0:
            spec[T_i] = axes.model
        elif shape[hd_i] % axes.size(axes.model) == 0:
            spec[hd_i] = axes.model
        return P(*spec)

    return map_with_path(leaf_spec, cache)
