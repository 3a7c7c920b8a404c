"""Lero-style learning-to-rank optimizer (§II-b, §VII-A3b).

Candidate generation follows Lero's mechanism: perturb the native
optimizer's cardinality estimates by scale factors and re-run join
enumeration — different factors surface genuinely different plans. A
pairwise comparator (MLP over plan feature vectors, trained with logistic
pairwise loss on observed latencies) picks the predicted-fastest candidate.

Cost accounting mirrors the paper: every candidate costs one EXPLAIN
(planning + plan serialization overhead), which is why Lero's optimization
time dominates its wins on short queries (Fig. 7).

The comparator is `nets.MLPHead` in PyTorch on `device` (None means
CUDA, and raises without one), drawn from the reference's key
(`split(PRNGKey(seed), 1)[0]`), trained by the hand-written AdamW in
place. Each candidate is scored by its own call and device->host copy,
as the reference scores them; the pairwise loss is
`logaddexp(sa - sb, 0)`, the reference's `jax.nn.softplus`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import nets, prng
from repro_torch.core.agent import param_tree, resolve_device
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sql.cbo import Estimator, cbo_plan
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.executor import RunResult, annotate_methods, run_adaptive
from repro_torch.sql.plans import Join, Leaf, Node, joins, leaves, syntactic_plan
from repro_torch.tree import nest

EXPLAIN_OVERHEAD = 0.8       # s per EXPLAIN (modeled engine round-trip)
SCALE_FACTORS = (0.01, 0.1, 1.0, 10.0, 100.0)
FEAT_DIM = 24


@dataclasses.dataclass
class _ScaledEstimator(Estimator):
    factor: float = 1.0

    def join_rows(self, query, l_set, l_rows, r_set, r_rows):
        return super().join_rows(query, l_set, l_rows, r_set, r_rows) * self.factor


def plan_features(plan: Node, query, est: Estimator) -> np.ndarray:
    """Fixed-size plan descriptor: depth stats + estimated cardinality
    profile along the join sequence (log-space), padded."""
    f = np.zeros(FEAT_DIM, np.float32)
    js = joins(plan)
    f[0] = len(js)
    f[1] = float(max((_depth(plan), 1)))
    rows = []

    def est_rows(node) -> float:
        if isinstance(node, Leaf):
            return est.base_rows(query, node.alias)
        l = est_rows(node.left)
        r = est_rows(node.right)
        out = est.join_rows(query, frozenset(node.left.covered()), l,
                            frozenset(node.right.covered()), r)
        rows.append(out)
        return out

    est_rows(plan)
    prof = np.log1p(np.asarray(sorted(rows, reverse=True)[:FEAT_DIM - 4]))
    f[2] = float(np.log1p(sum(rows)))
    f[3] = float(np.log1p(max(rows) if rows else 0))
    f[4:4 + len(prof)] = prof
    return f


def _depth(node, d=1):
    if isinstance(node, Leaf):
        return d
    return max(_depth(node.left, d + 1), _depth(node.right, d + 1))


class LeroOptimizer:
    def __init__(self, db, est: Estimator, seed: int = 0,
                 cluster: ClusterModel = ClusterModel(), device=None):
        self.db, self.est, self.cluster = db, est, cluster
        self.device = resolve_device(device, "LeroOptimizer")
        k = prng.split(prng.prng_key(seed), 1)[0]
        self.net = nets.MLPHead(FEAT_DIM, 64, 1, k).to(self.device)
        self.opt = adamw_init(param_tree(self.net))
        self._ocfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
        self._pairs: List[Tuple[np.ndarray, np.ndarray]] = []

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.inference_mode()
    def _score(self, f: np.ndarray) -> float:
        return float(self.net(self._tensor(f))[0])

    def _update(self, xa, xb):
        # xa observed faster than xb -> want score(xa) < score(xb)
        d = self.net(xa)[:, 0] - self.net(xb)[:, 0]
        loss = torch.mean(torch.logaddexp(d, torch.zeros_like(d)))
        named = dict(self.net.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        adamw_update(nest(named), nest(dict(zip(named, grads))), self.opt,
                     self._ocfg)

    # ------------------------------------------------------------ candidates
    def candidates(self, query) -> Tuple[List[Node], float]:
        plans, sigs = [], set()
        t_plan = 0.0
        for fac in SCALE_FACTORS:
            est = _ScaledEstimator(self.est.db, self.est.stats, factor=fac)
            p, t = cbo_plan(query, est)
            t_plan += t + EXPLAIN_OVERHEAD
            sig = _order_sig(p)
            if sig not in sigs:
                sigs.add(sig)
                plans.append(annotate_methods(p, query, self.est, self.cluster))
        p0 = annotate_methods(syntactic_plan(query), query, self.est, self.cluster)
        if _order_sig(p0) not in sigs:
            plans.append(p0)
            t_plan += EXPLAIN_OVERHEAD
        return plans, t_plan

    # ------------------------------------------------------------ serving
    def choose(self, query) -> Tuple[Node, float, List[Node]]:
        plans, t_plan = self.candidates(query)
        feats = [plan_features(p, query, self.est) for p in plans]
        scores = [self._score(f) for f in feats]
        best = int(np.argmin(scores))
        return plans[best], t_plan, plans

    def run(self, query) -> RunResult:
        plan, t_plan, _ = self.choose(query)
        return run_adaptive(self.db, query, plan, self.est, self.cluster,
                            plan_time=t_plan)

    # ------------------------------------------------------------ training
    def train_episode(self, query, explore_all: bool = True):
        """Execute candidates, record pairwise labels (Lero explores its
        candidate set during training — 'even an unchosen plan at training
        at least belongs to its explored set', §VII-B5)."""
        plans, _ = self.candidates(query)
        results = []
        for p in plans[:4]:              # bound exploration cost
            r = run_adaptive(self.db, query, p, self.est, self.cluster)
            results.append((plan_features(p, query, self.est), r.latency))
        for i in range(len(results)):
            for j in range(len(results)):
                if results[i][1] < results[j][1]:
                    self._pairs.append((results[i][0], results[j][0]))
        self._fit()
        return results

    def _fit(self, batch: int = 64):
        if len(self._pairs) < 8:
            return
        idx = np.random.default_rng(len(self._pairs)).choice(
            len(self._pairs), size=min(batch, len(self._pairs)), replace=False)
        xa = self._tensor(np.stack([self._pairs[i][0] for i in idx]))
        xb = self._tensor(np.stack([self._pairs[i][1] for i in idx]))
        for _ in range(4):
            self._update(xa, xb)


def _order_sig(plan: Node) -> Tuple:
    return tuple(tuple(sorted(l.aliases)) for l in leaves(plan))
