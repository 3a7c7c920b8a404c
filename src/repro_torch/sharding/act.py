"""Activation-sharding policy, as the reference's `repro.sharding.act`.

The reference's model code calls ``constrain(x, {dim: role})`` at a few
key points, and the active :class:`ActivationPolicy` maps roles to mesh
axes with divisibility checks. The policy also carries the layout knobs
that the model paths read (`ce_chunk`, `remat`, `attn_remat`,
`attn_scores_bf16`, `mla_absorb`, `moe_dispatch`): those change what the
port computes on one card as they change what the reference computes.

The port runs on one card: `constrain` returns ``x`` itself, and
`spec_for` returns the spec the reference would constrain ``x`` to (for
the dry run and the tests). With no policy set both are no-ops, as in the
reference, and every model path takes its defaults.

Roles:
  "dp"  — batch-like dim  -> (pod, data) axes
  "tp"  — model-parallel dim (sequence, heads, vocab, experts, d_ff) -> model
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.sharding.rules import P

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class ActivationPolicy:
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    dp_size: int = 1
    tp_size: int = 1
    # ---- layout knobs (Plane B levers) ----
    attn_mode: str = "seq"        # seq | heads | none: which dim of q gets TP
    ce_chunk: Optional[int] = None   # override lm.CE_CHUNK
    remat: str = "full"           # full (nothing saved) | dots | none
    attn_remat: bool = False      # recompute attention probs in backward
                                  # (flash-bwd semantics: save only m/l/out)
    mla_absorb: bool = False      # MLA decode: score against the latent
                                  # (absorbed wkv_b), skip cache re-expansion
    attn_scores_bf16: bool = False  # store score/prob tensors in bf16
                                    # (f32 softmax math)
    moe_dispatch: str = "global"  # global | local | shard_map:
                                  #  local = per-block capacity slices
                                  #  shard_map = explicit per-shard dispatch
                                  #    + combine-sum (see models/moe.py)
    mesh: object = None           # a `launch.mesh.Mesh` descriptor

    def axes_for(self, role: str):
        if role == "dp":
            return (self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0],
                    self.dp_size)
        return self.tp_axis, self.tp_size


def current() -> Optional[ActivationPolicy]:
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def policy(p: Optional[ActivationPolicy]):
    prev = current()
    _state.policy = p
    try:
        yield
    finally:
        _state.policy = prev


def spec_for(shape, roles: Dict[int, str]) -> Optional[P]:
    """The spec the reference's `constrain` would apply to a tensor of
    `shape` under the active policy, or None where it applies none (no
    policy, or no dim that divides its axis). Dims whose size does not
    divide the target axis are left unsharded."""
    pol = current()
    if pol is None:
        return None
    spec = [None] * len(shape)
    for dim, role in roles.items():
        axis, size = pol.axes_for(role)
        if size > 1 and shape[dim] % size == 0 and shape[dim] > 1:
            spec[dim] = axis
    if all(s is None for s in spec):
        return None
    return P(*spec)


def constrain(x, roles: Dict[int, str]):
    """The reference's sharding constraint: on one card, `x` itself."""
    return x
