"""Activation-sharding policy, as the reference's `repro.sharding.act`.

The reference's model code calls ``constrain(x, {dim: role})`` at a few
key points, and the active :class:`ActivationPolicy` maps roles to mesh
axes with divisibility checks. The policy also carries the layout knobs
that the model paths read (`ce_chunk`, `remat`, `attn_remat`,
`attn_scores_bf16`, `mla_absorb`, `moe_dispatch`): those change what the
port computes on one card as they change what the reference computes.

`constrain` returns ``x`` itself (the port places no tensor by a spec:
dense layers stay whole on every rank), and `spec_for` returns the spec
the reference would constrain ``x`` to (for the dry run and the tests).
With no policy set both are no-ops, as in the reference, and every model
path takes its defaults.

The policy's `mesh` is a descriptor (`launch.mesh`), or a mesh joined
across processes, one rank a card (`launch.mesh.join_host_mesh`): then
the policy takes dp_size and tp_size from the mesh's shape, and the MoE
layers run only this rank's E/tp experts and sum the ranks' outputs with
`reduce_from_tp`, the reference's `psum` over the model axis
(`models/moe.py`). `copy_to_tp` and `reduce_from_tp` are the pair of
autograd Functions `shard_map` transposes into each other: the
replicated input passes forward as it is and its cotangent is summed over
the ranks; the psum's cotangent passes back as it is. So in a train step
every rank computes the whole gradient of every leaf it holds whole, and
its own experts' share of the expert leaves (`EXPERT_LEAVES`, the
leaves `split_leaves` names); the optimizer sums or maxes its statistics
of those leaves over the ranks (`reduce_stats`).
`across(mesh)` is the context a joined mesh's model calls run in.

Roles:
  "dp"  — batch-like dim  -> (pod, data) axes
  "tp"  — model-parallel dim (sequence, heads, vocab, experts, d_ff) -> model
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding.rules import P
from repro_torch.tree import flatten

_state = threading.local()

# the leaves a rank of a joined mesh holds experts [j E/tp, (j+1) E/tp) of,
# j its rank, (L, E, ...) each when stacked: the MoE layers' experts
EXPERT_LEAVES = ("moe_wg", "moe_wu", "moe_wd")

# all_reduce calls over a joined mesh: the MoE layers' psums (a
# prefill's, a decode step's, a train step's forward and its remat
# re-forward), copy_to_tp's cotangent sums, the optimizer's statistics
all_reduces = 0
cotangent_all_reduces = 0
stat_all_reduces = 0


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
    mesh: object = None           # a `launch.mesh.Mesh`: a descriptor, or
                                  # joined (dp/tp sizes from its shape)

    def __post_init__(self):
        if joined(self.mesh):
            object.__setattr__(self, "dp_size",
                               math.prod(self.mesh.shape[:-1]))
            object.__setattr__(self, "tp_size", self.mesh.shape[-1])

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


def bound(fn):
    """`fn` that runs under the policy active now, from whatever thread
    calls it: a checkpoint's recompute of CUDA work runs in autograd's
    device thread, which does not see this thread's policy."""
    pol = current()

    def run(*args, **kwargs):
        with policy(pol):
            return fn(*args, **kwargs)
    return run


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


# ------------------------------------------------------------- across ranks
def joined(mesh) -> bool:
    """Whether `mesh` is joined across processes (has a process group)."""
    return getattr(mesh, "group", None) is not None


def _all_reduce(x, mesh):
    global all_reduces
    import torch.distributed as dist
    dist.all_reduce(x, group=mesh.group)
    all_reduces += 1
    return x


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        global cotangent_all_reduces
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        cotangent_all_reduces += 1
        return g, None


def reduce_from_tp(x, mesh):
    """The psum over the joined mesh's ranks: the sum of every rank's `x`
    (in place where no gradient is taken); its backward passes the
    cotangent through. On `meta` (a dry run) `x` itself: no data."""
    if x.device.type == "meta":
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, mesh)
    return _all_reduce(x, mesh)


def copy_to_tp(x, mesh):
    """A replicated input of per-rank work: `x` forward; its backward sums
    the ranks' cotangents."""
    if torch.is_grad_enabled() and x.requires_grad \
            and x.device.type != "meta":
        return _CopyToTP.apply(x, mesh)
    return x


def split_leaves(tree, mesh):
    """The paths of `tree`'s leaves that a rank of the joined `mesh` holds
    a slice of (its experts of the `EXPERT_LEAVES`), in sorted-leaf order;
    none where `mesh` is not joined."""
    if not joined(mesh):
        return []
    return [path for path, _ in flatten(tree)
            if path.rsplit("/", 1)[-1] in EXPERT_LEAVES]


def reduce_stats(x, mesh, op="sum"):
    """An optimizer's per-rank statistics `x` of the expert leaves (sums
    of squares, largest magnitudes) summed ("sum") or maxed ("max") over
    the joined mesh's ranks, in place, so that every rank holds the whole
    leaves' values; on `meta` (a dry run) `x` itself: no data."""
    global stat_all_reduces
    if x.device.type == "meta":
        return x
    import torch.distributed as dist
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=mesh.group)
    stat_all_reduces += 1
    return x


def across(mesh):
    """The context the model calls of a rank of a joined `mesh` run in:
    the active policy (the default one if none) with the reference's
    `shard_map` dispatch over `mesh`; nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    if not joined(mesh):
        raise ValueError("a step across ranks takes a joined mesh "
                         "(launch.mesh.join_host_mesh)")
    return policy(dataclasses.replace(current() or ActivationPolicy(),
                                      moe_dispatch="shard_map", mesh=mesh))
