"""AutoSteer-style rule-toggle optimizer (§II-b, §VII-A3c).

AutoSteer systematically disables optimizer rules to generate plan
variants, then greedily composes the rule-disable set predicted fastest by
a learned model. Our engine's toggleable "rules":

  cbo        — cost-based join reordering (off -> syntactic order)
  aqe_switch — runtime SMJ->BHJ operator switching
  coalesce   — AQE shuffle-partition coalescing
  bjt_boost  — 4x broadcast threshold (aggressive broadcasting)

The learned predictor is an MLP over (query descriptor ++ toggle bitmask)
trained on observed latencies. The paper's characteristic failure mode —
favouring disabled high-overhead rules that backfire on complex queries
(Tab. II failures) — emerges naturally: disabling aqe_switch/cbo is often
fastest on small queries but catastrophic on join-heavy ones.

The predictor is `nets.MLPHead` in PyTorch on `device` (None means
CUDA, and raises without one), drawn from the reference's key
(`split(PRNGKey(seed), 1)[0]`), trained by the hand-written AdamW in
place. Each candidate toggle set is scored by its own call and
device->host copy, as the reference scores them.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import nets, prng
from repro_torch.core.agent import param_tree, resolve_device
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sql.cbo import Estimator, cbo_plan
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.executor import RunResult, annotate_methods, run_adaptive
from repro_torch.sql.plans import syntactic_plan
from repro_torch.tree import nest

RULES = ("cbo", "aqe_switch", "coalesce", "bjt_boost")
EXPLAIN_OVERHEAD = 0.4       # s per EXPLAIN; cheaper than Lero's (§VII-B2)
QFEAT = 12


def query_features(query, est: Estimator) -> np.ndarray:
    f = np.zeros(QFEAT, np.float32)
    f[0] = query.n_relations
    f[1] = len(query.conds)
    rows = sorted((est.base_rows(query, r.alias) for r in query.relations),
                  reverse=True)
    prof = np.log1p(np.asarray(rows[:QFEAT - 2]))
    f[2:2 + len(prof)] = prof
    return f


class AutoSteerOptimizer:
    def __init__(self, db, est: Estimator, seed: int = 0,
                 cluster: ClusterModel = ClusterModel(), device=None):
        self.db, self.est, self.cluster = db, est, cluster
        self.device = resolve_device(device, "AutoSteerOptimizer")
        k = prng.split(prng.prng_key(seed), 1)[0]
        self.net = nets.MLPHead(QFEAT + len(RULES), 64, 1, k).to(self.device)
        self.opt = adamw_init(param_tree(self.net))
        self._ocfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _update(self, x, y):
        loss = torch.mean((self.net(x)[:, 0] - y) ** 2)
        named = dict(self.net.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        adamw_update(nest(named), nest(dict(zip(named, grads))), self.opt,
                     self._ocfg)

    @torch.inference_mode()
    def _score(self, x: np.ndarray) -> float:
        return float(self.net(self._tensor(x))[0])

    # ------------------------------------------------------------- exec
    def run_with_toggles(self, query, disabled: Tuple[str, ...]) -> RunResult:
        cluster = self.cluster
        if "coalesce" in disabled:
            cluster = dataclasses.replace(cluster, aqe_coalesce=False)
        if "bjt_boost" not in disabled:      # boost is itself a toggle-ON rule
            pass
        if "bjt_boost" in disabled:
            cluster = dataclasses.replace(cluster, bjt=cluster.bjt * 4)
        if "cbo" in disabled:
            plan, t_plan = syntactic_plan(query), 0.0
        else:
            plan, t_plan = cbo_plan(query, self.est)
        plan = annotate_methods(plan, query, self.est, cluster)
        return run_adaptive(self.db, query, plan, self.est, cluster,
                            aqe_switching="aqe_switch" not in disabled,
                            plan_time=t_plan)

    # ------------------------------------------------------------- choose
    def _predict(self, query, disabled) -> float:
        x = np.concatenate([query_features(query, self.est),
                            np.array([1.0 if r in disabled else 0.0
                                      for r in RULES], np.float32)])
        return self._score(x)

    def choose(self, query) -> Tuple[Tuple[str, ...], float]:
        """Greedy hint-set construction (AutoSteer §4): start empty, add the
        single rule-disable predicted to help, repeat while improving.
        Charges one EXPLAIN per candidate evaluated."""
        n_explains = 1
        best: Tuple[str, ...] = ()
        best_pred = self._predict(query, best)
        improved = True
        while improved:
            improved = False
            for r in RULES:
                if r in best:
                    continue
                cand = best + (r,)
                n_explains += 1
                p = self._predict(query, cand)
                if p < best_pred:
                    best, best_pred, improved = cand, p, True
        return best, n_explains * EXPLAIN_OVERHEAD

    def run(self, query) -> RunResult:
        disabled, t_plan = self.choose(query)
        r = self.run_with_toggles(query, disabled)
        r.plan_time += t_plan
        return r

    # ------------------------------------------------------------- train
    def train_episode(self, query, rng: np.random.Generator):
        """Explore a random toggle set + the greedy set; fit the predictor."""
        cands = [(), tuple(rng.choice(RULES,
                                      size=rng.integers(1, 3), replace=False))]
        for disabled in cands:
            res = self.run_with_toggles(query, disabled)
            x = np.concatenate([query_features(query, self.est),
                                np.array([1.0 if r in disabled else 0.0
                                          for r in RULES], np.float32)])
            self._xs.append(x)
            self._ys.append(np.sqrt(res.latency))
        self._fit()

    def _fit(self, batch: int = 64):
        if len(self._xs) < 8:
            return
        rng = np.random.default_rng(len(self._xs))
        idx = rng.choice(len(self._xs), size=min(batch, len(self._xs)),
                         replace=False)
        x = self._tensor(np.stack([self._xs[i] for i in idx]))
        y = self._tensor(np.asarray([self._ys[i] for i in idx], np.float32))
        for _ in range(8):
            self._update(x, y)
