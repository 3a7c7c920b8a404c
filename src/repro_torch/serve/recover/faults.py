"""Seeded, virtual-clock fault injection.

A `FaultInjector` is a pure function of its seed: every fault decision is
drawn from a counter-based PRNG keyed by `(seed, kind, seq, attempt, k)`,
so the schedule is independent of lane count, batching window, scheduling
policy and host execution order — the same chaos replays bit-identically
through every scheduler configuration (which is what lets the fault
benchmark run the SAME storm through every recovery variant), and a
retry or hedge (a new `attempt`) rolls fresh dice, the way a re-run on a
different executor escapes a flaky host but not a deterministic OOM.

Fault kinds (all priced on the virtual clock):

  crash      the lane dies mid-stage: a fraction of the stage's seconds is
             charged, the in-flight run is lost (`QueryFailure("crash")`),
             and resume state is NOT salvageable — a retry restarts from
             scratch (the stage cache still shortcuts the numpy work, but
             latency is always re-charged).
  transient  a stage-level error (fetch failure, shuffle corruption): same
             charging, but the attempt's materialized stages survive, so a
             resume retry pays only the failed stage.
  slow       a per-attempt straggler multiplier (slow executor / noisy
             neighbour): every charge of the attempt is stretched by
             `factor`; the run itself succeeds unless the stretch trips
             the timeout. Sampled once per (seq, attempt).
  corrupt    stats corruption at admission: the believed row count of one
             of the query's base tables is scaled by `corrupt_factor`
             (the catalog lies to the CBO — downstream plans go bad until
             a re-ANALYZE or a failure-driven replan fixes them). Applied
             by the RecoveryManager on first-attempt admissions only.

The injector is inert when `enabled=False` or every probability is 0 —
the executor seam then never fires and completions are bit-identical to
the injector-less stack (pinned by tests/test_recover.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sql.executor import QueryFailure

# kind tags mixed into the PRNG key so the per-stage and per-run draws are
# independent streams
_K_STAGE, _K_RUN, _K_ADMIT = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str                  # "crash" | "transient" | "slow" | "corrupt"
    seq: int
    attempt: int
    k: int = -1                # charge index within the attempt (-1 = run)
    factor: float = 1.0        # slowdown multiplier / corruption scale
    frac: float = 0.5          # fraction of the stage charged before abort
    table: str = ""            # corrupted table (kind == "corrupt")


class RunFaults:
    """Per-attempt view handed to `AdaptiveRun(faults=...)`: consulted at
    every latency charge, in the executor's deterministic charge order."""

    def __init__(self, injector: "FaultInjector", seq: int, attempt: int):
        self._inj = injector
        self._seq, self._attempt = seq, attempt
        self._k = 0
        self.slow_factor = injector.run_slowdown(seq, attempt)

    def charge(self, seconds: float, state) -> float:
        ev = self._inj.stage_fault(self._seq, self._attempt, self._k)
        self._k += 1
        seconds *= self.slow_factor
        if ev is None:
            return seconds
        # the stage dies part-way through: charge the wasted fraction, then
        # abort the run with the injected kind
        state.elapsed += seconds * ev.frac
        self._inj.log.append(ev)
        raise QueryFailure(ev.kind, f"injected at charge {ev.k}")


class FaultInjector:
    def __init__(self, seed: int = 0, *, p_crash: float = 0.0,
                 p_transient: float = 0.0, p_slow: float = 0.0,
                 slow_factor: Tuple[float, float] = (8.0, 32.0),
                 fault_frac: float = 0.5,
                 p_corrupt: float = 0.0, corrupt_factor: float = 0.02,
                 window: Optional[Tuple[int, int]] = None,
                 enabled: bool = True):
        """`window=(lo, hi)` confines every draw to stream positions
        lo <= seq < hi — a seeded fault BURST (an outage with a start and
        an end) instead of a uniform storm. Queries outside the window
        see an inert injector, and the counter-based keying means the
        in-window schedule is unchanged by the gate. Default None keeps
        the original uniform behavior bit-identical."""
        assert p_crash + p_transient <= 1.0
        self.seed = int(seed)
        self.p_crash, self.p_transient = p_crash, p_transient
        self.p_slow = p_slow
        self.slow_factor = slow_factor
        self.fault_frac = fault_frac
        self.p_corrupt, self.corrupt_factor = p_corrupt, corrupt_factor
        self.window = None if window is None else (int(window[0]),
                                                   int(window[1]))
        self.enabled = enabled
        self.log: List[FaultEvent] = []      # events that actually FIRED

    @property
    def active(self) -> bool:
        return self.enabled and (self.p_crash > 0 or self.p_transient > 0
                                 or self.p_slow > 0 or self.p_corrupt > 0)

    def _rng(self, kind_tag: int, seq: int, attempt: int, k: int = 0):
        return np.random.default_rng(
            (self.seed, kind_tag, seq, attempt, k))

    def _in_window(self, seq: int) -> bool:
        return self.window is None or \
            self.window[0] <= seq < self.window[1]

    # ---------------------------------------------------------- sampling
    def run_faults(self, seq: int, attempt: int) -> Optional[RunFaults]:
        """The fault profile for one attempt, or None when inert."""
        if not self.active:
            return None
        rf = RunFaults(self, seq, attempt)
        if rf.slow_factor != 1.0:
            self.log.append(FaultEvent("slow", seq, attempt,
                                       factor=rf.slow_factor))
        return rf

    def run_slowdown(self, seq: int, attempt: int) -> float:
        """Straggler multiplier for this attempt (1.0 = healthy)."""
        if not (self.enabled and self.p_slow > 0) \
                or not self._in_window(seq):
            return 1.0
        rng = self._rng(_K_RUN, seq, attempt)
        if rng.random() >= self.p_slow:
            return 1.0
        lo, hi = self.slow_factor
        return float(lo + (hi - lo) * rng.random())

    def stage_fault(self, seq: int, attempt: int, k: int) \
            -> Optional[FaultEvent]:
        """Crash/transient decision for the k-th charge of an attempt."""
        if not (self.enabled and (self.p_crash > 0 or self.p_transient > 0)) \
                or not self._in_window(seq):
            return None
        u = float(self._rng(_K_STAGE, seq, attempt, k).random())
        if u < self.p_crash:
            return FaultEvent("crash", seq, attempt, k,
                              frac=self.fault_frac)
        if u < self.p_crash + self.p_transient:
            return FaultEvent("transient", seq, attempt, k,
                              frac=self.fault_frac)
        return None

    def admit_corruption(self, seq: int, tables: List[str]) \
            -> Optional[FaultEvent]:
        """Stats-corruption decision at a first-attempt admission: scale
        the believed nrows of one of the query's tables (sorted order, so
        the pick is stream-independent)."""
        if not (self.enabled and self.p_corrupt > 0) or not tables \
                or not self._in_window(seq):
            return None
        rng = self._rng(_K_ADMIT, seq, 0)
        if rng.random() >= self.p_corrupt:
            return None
        table = sorted(tables)[int(rng.integers(len(tables)))]
        ev = FaultEvent("corrupt", seq, 0, factor=self.corrupt_factor,
                        table=table)
        self.log.append(ev)
        return ev

    # ------------------------------------------------------------- stats
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.log:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out


class ScriptedFaults(FaultInjector):
    """Deterministic test double: explicit events instead of sampling.

    `stage` maps (seq, attempt, charge_idx) -> "crash" | "transient";
    `slow` maps (seq, attempt) -> multiplier; `corrupt` maps seq ->
    (table, factor)."""

    def __init__(self, stage: Optional[dict] = None,
                 slow: Optional[dict] = None,
                 corrupt: Optional[dict] = None, fault_frac: float = 0.5):
        super().__init__(0, enabled=True, fault_frac=fault_frac)
        self._stage = dict(stage or {})
        self._slow = dict(slow or {})
        self._corrupt = dict(corrupt or {})

    @property
    def active(self) -> bool:
        return self.enabled and bool(self._stage or self._slow
                                     or self._corrupt)

    def run_slowdown(self, seq: int, attempt: int) -> float:
        return float(self._slow.get((seq, attempt), 1.0))

    def stage_fault(self, seq, attempt, k) -> Optional[FaultEvent]:
        kind = self._stage.get((seq, attempt, k))
        if kind is None:
            return None
        return FaultEvent(kind, seq, attempt, k, frac=self.fault_frac)

    def admit_corruption(self, seq, tables) -> Optional[FaultEvent]:
        hit = self._corrupt.get(seq)
        if hit is None:
            return None
        table, factor = hit
        ev = FaultEvent("corrupt", seq, 0, factor=factor, table=table)
        self.log.append(ev)
        return ev
