"""Elastic scaling + straggler mitigation (host-side control plane).

Design for 1000+ nodes (DESIGN.md §5): the `pod` mesh axis is pure data
parallelism — parameters are never sharded across it — so membership
changes are cheap:

  * pod loss: drop its logical data-shard range, rebalance ranges over
    survivors, shrink the mesh to (p-1, data, model), resume from the last
    step-atomic checkpoint (in-flight step is discarded; determinism of the
    data pipeline means no sample is lost or duplicated).
  * pod join: extend the mesh, hand the newcomer a range, restore params
    from any survivor's checkpoint (params are replicated across pods).

Straggler mitigation: per-step host heartbeats feed an EWMA of step time;
hosts slower than `threshold x median` for `patience` consecutive steps
are marked for eviction (the same rebalance path as pod loss) — on real
fleets this is the "kill the sick node, don't wait for it" policy.
This module is deliberately device-free (pure control logic) so it is unit
testable here and drivable by any launcher.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShardAssignment:
    pod: int
    lo: int
    hi: int


class ElasticPlanner:
    def __init__(self, n_logical_shards: int = 256):
        self.n_logical = n_logical_shards

    def assign(self, pods: Sequence[int]) -> List[ShardAssignment]:
        """Contiguous balanced ranges over live pods (deterministic)."""
        pods = sorted(pods)
        n = len(pods)
        per = self.n_logical // n
        rem = self.n_logical % n
        out, lo = [], 0
        for i, p in enumerate(pods):
            hi = lo + per + (1 if i < rem else 0)
            out.append(ShardAssignment(p, lo, hi))
            lo = hi
        assert lo == self.n_logical
        return out

    def on_membership_change(self, old: Sequence[int], new: Sequence[int]
                             ) -> Dict[str, object]:
        """Plan the transition: which ranges move, what mesh to rebuild."""
        new_assign = self.assign(new)
        return {
            "mesh_pods": len(new),
            "assignments": new_assign,
            "action": "restore_from_checkpoint_and_resume",
            "lost": sorted(set(old) - set(new)),
            "joined": sorted(set(new) - set(old)),
        }


@dataclasses.dataclass
class _HostStat:
    ewma: float = 0.0
    slow_streak: int = 0


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, patience: int = 5,
                 alpha: float = 0.3):
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.stats: Dict[int, _HostStat] = {}

    def report(self, host: int, step_seconds: float):
        s = self.stats.setdefault(host, _HostStat(step_seconds))
        s.ewma = (1 - self.alpha) * s.ewma + self.alpha * step_seconds

    def evictions(self) -> List[int]:
        if len(self.stats) < 2:
            return []
        med = sorted(s.ewma for s in self.stats.values())[len(self.stats) // 2]
        out = []
        for h, s in self.stats.items():
            if s.ewma > self.threshold * med:
                s.slow_streak += 1
            else:
                s.slow_streak = 0
            if s.slow_streak >= self.patience:
                out.append(h)
        return sorted(out)
