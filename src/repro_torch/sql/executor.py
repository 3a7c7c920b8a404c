"""Stage-based adaptive executor with exact cardinalities.

Execution is Spark-AQE-shaped: the remaining plan's next executable join
(leftmost join whose children are both materialized) runs as one *query
stage*; after each stage the runtime re-examines the remainder with TRUE
sizes — the rule-based AQE switches SMJ<->BHJ exactly like Spark 3.x, and
the *extension hook* (AQORA's planner extension, §VI) may rewrite the
remaining plan (swap/lead/broadcast/cbo) before execution resumes.

Joins compute exact match counts first (cheap: sort + searchsorted), so an
exploding intermediate is detected and charged as OOM *without*
materializing it — the same way a Spark executor dies before finishing.

Latency is charged against `ClusterModel` (see cluster.py); cardinalities,
shuffle counts and bytes are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Generator, List, Optional, Tuple

import numpy as np

from repro_torch.serve.cache import StageCache
from repro_torch.sql.catalog import Database
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.plans import (BHJ, Join, Leaf, Node, SMJ, copy_plan, joins,
                             leaves)
from repro_torch.sql.query import Query


class QueryFailure(Exception):
    # natural kinds: "oom" | "timeout"; injected (serve.recover.faults):
    # "crash" (lane lost, in-flight work gone) | "transient" (stage error)
    def __init__(self, kind: str, msg: str = ""):
        super().__init__(f"{kind}: {msg}")
        self.kind = kind


@dataclasses.dataclass
class MaterializedRel:
    aliases: frozenset
    columns: Dict[Tuple[str, str], np.ndarray]   # (alias, col) -> values
    nrows: int
    width: float                                 # modeled row width (bytes)
    partitioned_on: Optional[Tuple[str, str]] = None
    sig: Optional[tuple] = None                  # structural signature: the
    #   deterministic derivation of this rel (stage-reuse cache key)

    @property
    def bytes(self) -> float:
        return self.nrows * self.width


@dataclasses.dataclass
class StageRecord:
    """Telemetry for one completed stage (one join or scan batch)."""
    covered: frozenset
    method: str
    out_rows: int
    out_bytes: float
    shuffles: int
    shuffle_bytes: float
    seconds: float


@dataclasses.dataclass
class RunResult:
    latency: float                 # C_execute (simulated seconds, capped)
    plan_time: float               # C_plan contribution from the optimizer
    failed: bool
    failure_kind: str
    stages: List[StageRecord]
    total_shuffles: int
    total_shuffle_bytes: float
    final_plan: Optional[Node]
    bushy: bool

    @property
    def total(self) -> float:
        return self.latency + self.plan_time


# ------------------------------------------------------------------ joins
def _join_indices(lkey: np.ndarray, rkey: np.ndarray, cap: int):
    """Exact inner-join row indices. Counts matches first; raises on blowup."""
    order = np.argsort(rkey, kind="stable")
    rs = rkey[order]
    lo = np.searchsorted(rs, lkey, "left")
    hi = np.searchsorted(rs, lkey, "right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total > cap:
        raise QueryFailure("oom", f"join output {total} rows exceeds cap")
    lidx = np.repeat(np.arange(len(lkey)), cnt)
    starts = np.repeat(lo, cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ridx = order[starts + offs]
    return lidx, ridx


def _needed_cols(query: Query, alias: str) -> List[str]:
    cols = set()
    for c in query.conds:
        if c.left == alias:
            cols.add(c.lcol)
        if c.right == alias:
            cols.add(c.rcol)
    return sorted(cols) or ["id"]      # no join key: keep the row id


class Executor:
    """Stage executor with cross-run stage reuse (Spark's ReuseExchange,
    lifted across episodes and live queries): scans and join ROW SETS are
    deterministic given (table@version, filters, conds), so repeated
    executions of the same query — the training loop replays its workload
    every episode; the serving layer sees repeated template hits — skip
    the numpy work and only re-charge the modeled latency. Latency,
    shuffle accounting and OOM checks are always recomputed against THIS
    run's cluster, so results are bit-identical with the cache off.

    The cache itself is a `serve.cache.StageCache` shared via the database
    object: LRU eviction under a byte budget, and every signature embeds
    the base tables' version tags, so delta-table updates invalidate
    derived entries in O(1)."""

    _CACHE_MAX_BYTES = 256 * 1024 * 1024   # default budget for auto-created
    _ENTRY_MAX_BYTES = 32 * 1024 * 1024    #   caches; huge stages not pinned

    def __init__(self, db: Database, cluster: Optional[ClusterModel] = None,
                 reuse_stages: bool = True,
                 cache: Optional[StageCache] = None):
        self.db = db
        self.cluster = cluster if cluster is not None else ClusterModel()
        if not reuse_stages:
            self._cache = None
        elif cache is not None:
            # explicit cache (e.g. one tenant's partition of a
            # serve.cache.PartitionedStageCache, routed by the scheduler)
            self._cache = cache
        else:
            cache = getattr(db, "_stage_cache", None)
            if not isinstance(cache, StageCache):
                cache = StageCache(self._CACHE_MAX_BYTES,
                                   self._ENTRY_MAX_BYTES)
                db._stage_cache = cache
            self._cache = cache

    @property
    def cache_stats(self):
        """hit/miss/evict/invalidate counters of the attached stage cache
        (`serve.cache.CacheStats`), or None when reuse is off."""
        return None if self._cache is None else self._cache.stats

    # -------------------------------------------------- base scan
    def scan(self, query: Query, alias: str) -> Tuple[MaterializedRel, float]:
        rel = query.relation(alias)
        t = self.db.table(rel.table)
        need = tuple(_needed_cols(query, alias))
        sig = ("s", alias, rel.table, rel.filters, need,
               self.db.table_version(rel.table))
        secs = self.cluster.scan_time(t.bytes())
        if self._cache is not None:
            hit = self._cache.get(sig)
            if hit is not None:
                cols, nrows = hit
                width = 8.0 * max(1, t.ncols)
                return MaterializedRel(frozenset([alias]), dict(cols), nrows,
                                       width, sig=sig), secs
        mask = np.ones(t.nrows, bool)
        for f in rel.filters:
            mask &= f.apply(t.columns[f.column])
        idx = np.flatnonzero(mask)
        cols = {}
        for c in need:
            if c in t.columns:
                cols[(alias, c)] = t.columns[c][idx]
            else:                        # implicit PK "id" = row index
                cols[(alias, c)] = idx.astype(np.int64)
        width = 8.0 * max(1, t.ncols)
        m = MaterializedRel(frozenset([alias]), cols, len(idx), width,
                            sig=sig)
        if self._cache is not None:
            nbytes = sum(v.nbytes for v in cols.values())
            self._cache.put(sig, (dict(cols), len(idx)), nbytes)
        return m, secs

    # -------------------------------------------------- join stage
    def join(self, query: Query, left: MaterializedRel, right: MaterializedRel,
             conds, method: str) -> Tuple[MaterializedRel, StageRecord]:
        cl = self.cluster
        c0 = conds[0]
        # orient: c0.left must live in `left`
        if c0.left in left.aliases:
            key_l, key_r = (c0.left, c0.lcol), (c0.right, c0.rcol)
        else:
            key_l, key_r = (c0.right, c0.rcol), (c0.left, c0.lcol)

        sig = None
        if self._cache is not None and left.sig is not None \
                and right.sig is not None:
            sig = ("j", left.sig, right.sig, tuple(conds))
        hit = self._cache.get(sig) if sig is not None else None
        if hit is not None:
            out_cols, nrows, pre_total = hit
            # the matched-rows cap guards THIS run's cluster, not the one
            # that populated the cache
            if pre_total > cl.materialize_cap:
                raise QueryFailure(
                    "oom", f"join output {pre_total} rows exceeds cap")
            out = MaterializedRel(left.aliases | right.aliases,
                                  dict(out_cols), nrows,
                                  left.width + right.width, sig=sig)
        else:
            lkey = left.columns[key_l]
            rkey = right.columns[key_r]
            lidx, ridx = _join_indices(lkey, rkey, cl.materialize_cap)
            pre_total = len(lidx)
            # residual equality conditions
            keep = np.ones(len(lidx), bool)
            for c in conds[1:]:
                if c.left in left.aliases:
                    la, ra = (c.left, c.lcol), (c.right, c.rcol)
                else:
                    la, ra = (c.right, c.rcol), (c.left, c.lcol)
                keep &= left.columns[la][lidx] == right.columns[ra][ridx]
            if not keep.all():
                lidx, ridx = lidx[keep], ridx[keep]
            out_cols = {k: v[lidx] for k, v in left.columns.items()}
            out_cols.update({k: v[ridx] for k, v in right.columns.items()})
            out = MaterializedRel(left.aliases | right.aliases, out_cols,
                                  len(lidx), left.width + right.width,
                                  sig=sig)
            if sig is not None:
                nbytes = sum(v.nbytes for v in out_cols.values())
                self._cache.put(sig, (dict(out_cols), len(lidx), pre_total),
                                nbytes)

        # ---- latency + shuffle accounting
        shuffles = 0
        shuffle_bytes = 0.0
        if method == SMJ:
            t = cl.stage_overhead
            for side, key in ((left, key_l), (right, key_r)):
                if side.partitioned_on != key:
                    shuffles += 1
                    shuffle_bytes += side.bytes
                    t += cl.shuffle_time(side.bytes)
            t += cl.smj_cpu(left.nrows, right.nrows, out.nrows)
            out.partitioned_on = key_l
        else:  # BHJ: smaller side broadcast
            build, probe = (left, right) if left.bytes <= right.bytes else (right, left)
            if cl.broadcast_oom(build.bytes):
                raise QueryFailure("oom",
                                   f"broadcast build {build.bytes/1e6:.1f} MB")
            t = cl.stage_overhead + cl.broadcast_time(build.bytes)
            t += cl.bhj_cpu(build.nrows, probe.nrows, out.nrows)
            out.partitioned_on = probe.partitioned_on
        rec = StageRecord(out.aliases, method, out.nrows, out.bytes,
                          shuffles, shuffle_bytes, t)
        return out, rec


# ------------------------------------------------------------------ AQE run
@dataclasses.dataclass
class RuntimeState:
    """What the extension hook sees at a stage boundary."""
    query: Query
    plan: Node                                   # remaining plan
    mats: Dict[frozenset, MaterializedRel]       # materialized leaves
    est: Estimator
    step: int                                    # hook invocations so far
    elapsed: float
    stages_done: int
    cluster: Optional[ClusterModel] = None       # the run's configured cluster

    def leaf_rows(self, leaf: Leaf) -> Optional[int]:
        m = self.mats.get(leaf.covered())
        return None if m is None else m.nrows

    def leaf_bytes(self, leaf: Leaf) -> Optional[float]:
        m = self.mats.get(leaf.covered())
        return None if m is None else m.bytes

    def leaf_bytes_est(self, leaf: Leaf) -> float:
        m = self.mats.get(leaf.covered())
        if m is not None:
            return m.bytes
        return self.est.base_bytes(self.query, leaf.alias)

    def planned_shuffles(self) -> int:
        return planned_shuffles(self.plan, self)


def planned_shuffles(plan: Node, state: RuntimeState) -> int:
    """Shuffle exchanges the remaining plan would execute, using actual
    sizes where known and estimates elsewhere (drives the shaping reward
    r_i = -(Δ shuffles)/10)."""
    cluster = state.cluster if state.cluster is not None else ClusterModel()
    count = 0

    def visit(node) -> Tuple[float, Optional[Tuple[str, str]]]:
        nonlocal count
        if isinstance(node, Leaf):
            m = state.mats.get(node.covered())
            if m is not None:
                return m.bytes, m.partitioned_on
            return state.leaf_bytes_est(node), None
        lb, lpart = visit(node.left)
        rb, rpart = visit(node.right)
        c0 = node.conds[0]
        lkey = (c0.left, c0.lcol) if c0.left in node.left.covered() else (c0.right, c0.rcol)
        rkey = (c0.right, c0.rcol) if c0.left in node.left.covered() else (c0.left, c0.lcol)
        method = node.method
        if any(isinstance(ch, Leaf) and ch.broadcast_hint
               for ch in (node.left, node.right)):
            method = BHJ
        elif min(lb, rb) < cluster.bjt:
            method = BHJ
        if method == SMJ:
            if lpart != lkey:
                count += 1
            if rpart != rkey:
                count += 1
            out_part = lkey
        else:
            out_part = rpart if lb <= rb else lpart
        # crude size propagation for planning purposes only
        return max(lb, rb), out_part

    visit(plan)
    return count


HookFn = Callable[[RuntimeState], Optional[Node]]


def annotate_methods(plan: Node, query: Query, est: Estimator,
                     cluster: ClusterModel) -> Node:
    """Static (pre-execution) operator selection from ESTIMATES — what the
    planner believes; AQE may later override with actual sizes."""
    def est_bytes(node) -> float:
        if isinstance(node, Leaf):
            return est.base_bytes(query, node.alias)
        return max(est_bytes(node.left), est_bytes(node.right))

    def visit(node):
        if isinstance(node, Leaf):
            return
        visit(node.left)
        visit(node.right)
        lb, rb = est_bytes(node.left), est_bytes(node.right)
        node.method = BHJ if min(lb, rb) < cluster.bjt else SMJ
    visit(plan)
    return plan


class AdaptiveRun:
    """Resumable adaptive execution of ONE query.

    The extension hook becomes a suspension point instead of a callback:
    `start()` advances execution to the first stage boundary with hook
    budget remaining and returns the `RuntimeState`; `resume(new_plan)`
    injects the hook's decision (a replacement remaining plan, or None to
    keep the current one) and advances to the next boundary. When the query
    runs to completion or fails, the call returns None and `result` holds
    the finished `RunResult`.

    This is what lets `core.vec_rollout` hold B suspended runs and feed all
    their pending states through one batched policy call per lockstep step;
    `run_adaptive` below drives a single run with the legacy callback.
    """

    def __init__(self, db: Database, query: Query, plan: Node, est: Estimator,
                 cluster: Optional[ClusterModel] = None,
                 max_hook_steps: int = 3,
                 plan_time: float = 0.0,
                 aqe_switching: bool = True,
                 reuse_stages: bool = True,
                 cache: Optional[StageCache] = None,
                 faults=None,
                 init_mats: Optional[Dict[frozenset, MaterializedRel]] = None,
                 init_stages_done: int = 0,
                 trace=None):
        """`faults` is an optional per-run fault profile (an object with
        `charge(seconds, state) -> seconds` that may raise `QueryFailure`,
        see serve.recover.faults) consulted at every latency charge; None
        keeps the execution path bit-identical. `init_mats` /
        `init_stages_done` seed the run with already-materialized stage
        results (a retry resuming from its failed attempt's last stage
        boundary: it pays only the stages the plan still contains).
        `trace` is an optional per-attempt sink (duck-typed like
        serve.obs.RunTrace: `scan`/`stage`/`fail`) that receives elapsed-
        offset stage notes; None skips every note, bit-identically."""
        self.cluster = cluster if cluster is not None else ClusterModel()
        self.query = query
        self.max_hook_steps = max_hook_steps
        self.plan_time = plan_time
        self.aqe_switching = aqe_switching
        self.state = RuntimeState(query, copy_plan(plan),
                                  dict(init_mats) if init_mats else {},
                                  est, 0, 0.0, int(init_stages_done),
                                  self.cluster)
        self._faults = faults
        self._trace = trace
        self.result: Optional[RunResult] = None
        self._ex = Executor(db, self.cluster, reuse_stages=reuse_stages,
                            cache=cache)
        self._stages: List[StageRecord] = []
        self._tot_shuffles = 0
        self._tot_sbytes = 0.0
        self._bushy = False
        self._failure: Optional[QueryFailure] = None
        self._gen = self._drive()
        self._started = False

    @property
    def done(self) -> bool:
        return self.result is not None

    # ------------------------------------------------------------- driving
    def start(self) -> Optional[RuntimeState]:
        """Advance to the first suspension point (or to completion)."""
        assert not self._started, "start() may only be called once"
        self._started = True
        return self._step(lambda: next(self._gen))

    def resume(self, new_plan: Optional[Node] = None) -> Optional[RuntimeState]:
        """Deliver the hook's decision and advance to the next boundary."""
        assert self._started, "call start() before resume()"
        if self.result is not None:
            return None
        return self._step(lambda: self._gen.send(new_plan))

    def _step(self, advance) -> Optional[RuntimeState]:
        try:
            return advance()
        except StopIteration:
            cl, st = self.cluster, self.state
            if self._failure is not None:
                # failure pricing is the cluster's call: full timeout for
                # the legacy modes, detection-time + spill otherwise
                charge = cl.failure_charge(self._failure.kind, st.elapsed)
                self.result = RunResult(charge, self.plan_time, True,
                                        self._failure.kind, self._stages,
                                        self._tot_shuffles, self._tot_sbytes,
                                        st.plan, self._bushy)
            else:
                self.result = RunResult(st.elapsed, self.plan_time, False, "",
                                        self._stages, self._tot_shuffles,
                                        self._tot_sbytes, st.plan, self._bushy)
            return None

    # ----------------------------------------------------------- execution
    def _drive(self) -> Generator[RuntimeState, Optional[Node], None]:
        state, cluster, ex, query = (self.state, self.cluster, self._ex,
                                     self.query)
        trace = self._trace

        def charge(seconds: float):
            if self._faults is not None:
                # the fault profile may stretch the charge (straggler
                # multiplier) or abort it mid-stage (crash/transient)
                seconds = self._faults.charge(seconds, state)
            state.elapsed += seconds
            if state.elapsed >= cluster.timeout:
                raise QueryFailure("timeout", f"{state.elapsed:.1f}s")

        def scan_charged(alias: str) -> MaterializedRel:
            """Scan + charge, with an optional trace note (cache hit
            detected by the stats delta around the executor call)."""
            if trace is None:
                m, secs = ex.scan(query, alias)
                charge(secs)
                return m
            cs = ex.cache_stats
            h0 = cs.hits if cs is not None else 0
            e0 = state.elapsed
            m, secs = ex.scan(query, alias)
            charge(secs)
            trace.scan(alias, e0, state.elapsed, m.nrows,
                       cs is not None and cs.hits > h0)
            return m

        try:
            while True:
                # ---- extension hook (pre-exec at step 0, then per stage)
                if state.step < self.max_hook_steps:
                    new_plan = yield state
                    state.step += 1
                    if new_plan is not None:
                        state.plan = new_plan
                if isinstance(state.plan, Leaf):
                    # plan may be a single leaf only if query has 1 relation
                    if state.plan.covered() not in state.mats:
                        m = scan_charged(state.plan.alias)
                        state.mats[m.aliases] = m
                    return

                # ---- find next executable join (leftmost-deepest)
                def next_join(node) -> Optional[Join]:
                    if isinstance(node, Leaf):
                        return None
                    j = next_join(node.left)
                    if j is not None:
                        return j
                    j = next_join(node.right)
                    if j is not None:
                        return j
                    if isinstance(node.left, Leaf) and isinstance(node.right, Leaf):
                        return node
                    return None

                jn = next_join(state.plan)
                assert jn is not None
                # materialize child scans
                sides = []
                for ch in (jn.left, jn.right):
                    key = ch.covered()
                    if key not in state.mats:
                        state.mats[key] = scan_charged(ch.alias)
                    sides.append(state.mats[key])
                left_m, right_m = sides

                # ---- AQE operator selection with ACTUAL sizes (Spark rule)
                method = jn.method
                hinted = any(isinstance(ch, Leaf) and ch.broadcast_hint
                             for ch in (jn.left, jn.right))
                if hinted:
                    method = BHJ
                elif self.aqe_switching:
                    # Spark AQE: re-decide from ACTUAL sizes at the boundary
                    method = BHJ if min(left_m.bytes, right_m.bytes) < cluster.bjt \
                        else SMJ

                # joining two multi-alias intermediates == bushy shape (§VI-B1)
                if len(left_m.aliases) > 1 and len(right_m.aliases) > 1:
                    self._bushy = True
                if trace is None:
                    out, rec = ex.join(query, left_m, right_m, jn.conds,
                                       method)
                    charge(rec.seconds)
                else:
                    # estimated-vs-actual rows only priced when tracing:
                    # the estimate is pure observation, never fed back
                    est_rows = state.est.join_rows(
                        query, left_m.aliases, float(left_m.nrows),
                        right_m.aliases, float(right_m.nrows))
                    cs = ex.cache_stats
                    h0 = cs.hits if cs is not None else 0
                    e0 = state.elapsed
                    out, rec = ex.join(query, left_m, right_m, jn.conds,
                                       method)
                    charge(rec.seconds)
                    trace.stage(out.aliases, method, e0, state.elapsed,
                                out.nrows, est_rows, rec.shuffles,
                                cs is not None and cs.hits > h0)
                self._stages.append(rec)
                self._tot_shuffles += rec.shuffles
                self._tot_sbytes += rec.shuffle_bytes
                state.stages_done += 1
                state.mats[out.aliases] = out

                # ---- replace the executed join by a stage-result leaf
                new_leaf = Leaf(out.aliases, stage_id=state.stages_done)

                def replace(node):
                    if node is jn:
                        return new_leaf
                    if isinstance(node, Leaf):
                        return node
                    node.left = replace(node.left)
                    node.right = replace(node.right)
                    return node

                state.plan = replace(state.plan)
                if isinstance(state.plan, Leaf):
                    return
        except QueryFailure as f:
            self._failure = f
            if trace is not None:
                trace.fail(f.kind, state.elapsed)
            return


def run_adaptive(db: Database, query: Query, plan: Node, est: Estimator,
                 cluster: Optional[ClusterModel] = None,
                 hook: Optional[HookFn] = None,
                 max_hook_steps: int = 3,
                 plan_time: float = 0.0,
                 aqe_switching: bool = True,
                 reuse_stages: bool = True) -> RunResult:
    """Execute `plan` stage-by-stage with AQE + optional extension hook.

    The hook is invoked at stage boundaries (including once pre-execution,
    matching AQORA's two-phase optimization) at most `max_hook_steps` times;
    it may return a REPLACEMENT remaining plan (built from the same leaves).
    Implemented by driving an `AdaptiveRun` to completion.
    """
    run = AdaptiveRun(db, query, plan, est, cluster,
                      max_hook_steps=max_hook_steps if hook is not None else 0,
                      plan_time=plan_time, aqe_switching=aqe_switching,
                      reuse_stages=reuse_stages)
    st = run.start()
    while st is not None:
        st = run.resume(hook(st))
    return run.result


