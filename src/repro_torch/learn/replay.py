"""Prioritized experience replay for the lifelong-learning loop.

One `Experience` per served query: the full trajectory the scheduler
already produced (states/actions/logps/masks/rewards plus the terminal
latency baked into `traj.t_execute`), tagged with the per-table data
versions in force when the query finished. Priorities combine three
signals:

  recency         geometric decay in completions since harvest — the
                  serving distribution is the training distribution, and
                  it drifts;
  latency regret  how much worse this execution was than the best
                  completion seen for the same query template — high-
                  regret experience carries the gradient that actually
                  moves tail latency (outright failures get a further
                  `fail_boost`: timeouts/OOMs are the tail);
  freshness       experiences whose table-version tags still match the
                  live database outweigh pre-delta experience by
                  `fresh_boost` — after a delta lands, the old rows'
                  latencies describe a table that no longer exists.

Sampling is weighted-without-replacement from a caller-supplied seeded
`numpy` Generator, so a fixed seed makes the whole online loop
bit-reproducible.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Experience:
    seq: int                          # stream position of the completion
    query_name: str
    traj: object                      # core.rollout.Trajectory
    latency: float                    # virtual seconds (timeout if failed)
    failed: bool
    finish_t: float
    tables: Tuple[str, ...]           # base tables the query touches
    versions: Dict[str, int]          # per-table versions at completion
    harvest_idx: int = -1             # completion count at harvest time
    # failure-recovery tags (serve.recover): exactly ONE Experience is
    # harvested per query — the FINAL attempt's — so replay never
    # double-counts a retried query; these record what it took.
    attempts: int = 1                 # lane admissions the query consumed
    recovered: bool = False           # succeeded after >=1 failed attempt
    hedged: bool = False              # resolved through a hedge race


class ReplayBuffer:
    """Bounded FIFO of Experiences with recency x regret x freshness
    prioritized sampling."""

    def __init__(self, capacity: int = 512, *, recency_decay: float = 0.98,
                 regret_scale: float = 1.0, regret_cap: float = 4.0,
                 fresh_boost: float = 4.0, fail_boost: float = 2.0):
        assert 0.0 < recency_decay <= 1.0
        self.capacity = capacity
        self.recency_decay = recency_decay
        self.regret_scale = regret_scale
        self.regret_cap = regret_cap
        self.fresh_boost = fresh_boost
        self.fail_boost = fail_boost
        self._buf: deque = deque(maxlen=capacity)  # O(1) FIFO eviction
        self._best: Dict[str, float] = {}   # per-template best latency seen
        self.n_added = 0
        self.n_evicted = 0

    def __len__(self) -> int:
        return len(self._buf)

    def add(self, exp: Experience) -> None:
        exp.harvest_idx = self.n_added
        self.n_added += 1
        b = self._best.get(exp.query_name)
        if b is None or exp.latency < b:
            self._best[exp.query_name] = exp.latency
        if len(self._buf) == self.capacity:
            self.n_evicted += 1          # deque(maxlen) drops the oldest
        self._buf.append(exp)

    def regret(self, exp: Experience) -> float:
        """Relative latency regret vs the best seen for this template."""
        return self.regret_for(exp.query_name, exp.latency)

    def regret_for(self, query_name: str, latency: float) -> float:
        """Relative latency regret of one observation vs the best latency
        seen for its template (0.0 for a never-seen template). The drift
        detector reads this per completion: sustained regret on a
        template's tables is execution-level evidence the data moved."""
        best = self._best.get(query_name, latency)
        return (latency - best) / max(best, 1e-9)

    def priorities(self, current_versions: Dict[str, int]) -> np.ndarray:
        now = self.n_added
        out = np.empty(len(self._buf), np.float64)
        for i, e in enumerate(self._buf):
            w = self.recency_decay ** (now - 1 - e.harvest_idx)
            w *= 1.0 + self.regret_scale * min(self.regret(e), self.regret_cap)
            if e.failed:               # timeouts/OOMs carry the strongest
                w *= self.fail_boost   #   unlearning gradient
            fresh = all(current_versions.get(t, 0) == e.versions.get(t, 0)
                        for t in e.tables)
            if fresh:
                w *= self.fresh_boost
            out[i] = w
        return out

    def sample(self, k: int, rng: np.random.Generator,
               current_versions: Optional[Dict[str, int]] = None
               ) -> List[Experience]:
        """k experiences, weighted without replacement (deterministic given
        `rng`'s state). Returns fewer than k only if the buffer is small."""
        if not self._buf:
            return []
        p = self.priorities(current_versions or {})
        p = p / p.sum()
        k = min(k, len(self._buf))
        idx = rng.choice(len(self._buf), size=k, replace=False, p=p)
        return [self._buf[i] for i in idx]

    def all(self) -> List[Experience]:
        """Every buffered experience in stream (seq) order."""
        return sorted(self._buf, key=lambda e: e.seq)

    def stats(self) -> Dict[str, float]:
        return {"size": len(self._buf), "added": self.n_added,
                "evicted": self.n_evicted,
                "templates": len(self._best)}
