"""Post-swap circuit breaker on the PolicyStore.

The original gate is PRE-swap only: a candidate beats the incumbent on an
offline probe set, gets committed, and from then on nothing watches it.
A policy that probes well can still regress live — the probe set goes
stale under drift, and serving traffic exercises states the probe never
covered. The breaker closes that loop from LIVE completions:

  baseline   a rolling window of the last `window` completions (failure
             flags + latencies) is maintained at all times; when
             `store.serving_step` changes (a swap landed), the current
             window is frozen as the pre-swap baseline.
  watch      the next completions accumulate post-swap failure rate and
             mean latency; after at least `min_post` of them, the breaker
             TRIPS if post-swap failures exceed the baseline rate by
             `fail_margin` (absolute) or mean latency exceeds baseline x
             `latency_factor`.
  trip       `store.rollback(agent)` restores the newest version before
             the swapped step — the incumbent's exact params — and the
             store is forced into "shadow" mode for `cooldown`
             completions (candidates keep being scored but cannot swap),
             then restored to its prior mode. Trips are logged in
             `self.trips` as (completion seq, swapped step, restored
             step, reason).

Attached via the scheduler's `on_complete` hook (directly or through
`RecoveryManager(breaker=...)`), so detection and rollback land
deterministically between policy batches on the virtual clock.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional


class PolicyBreaker:
    def __init__(self, store, agent, *, window: int = 16,
                 min_post: int = 6, fail_margin: float = 0.2,
                 latency_factor: float = 2.0, cooldown: int = 32):
        self.store, self.agent = store, agent
        self.window, self.min_post = window, min_post
        self.fail_margin, self.latency_factor = fail_margin, latency_factor
        self.cooldown = cooldown
        self._hist: deque = deque(maxlen=window)   # (failed, latency)
        self._last_step = store.serving_step
        self._base: Optional[tuple] = None         # (fail_rate, mean_lat)
        self._watched_step = None
        self._post: List[tuple] = []
        self._cooldown_left = 0
        self._prior_mode: Optional[str] = None
        self.trips: List[tuple] = []
        self._sched = None

    # ------------------------------------------------------------- hooks
    def attach(self, scheduler) -> None:
        self._sched = scheduler
        if getattr(self.store, "obs", None) is None:
            self.store.obs = getattr(scheduler, "obs", None)
        scheduler.on_complete.append(self.on_complete)

    def _freeze_baseline(self) -> Optional[tuple]:
        if not self._hist:
            return None
        fails = sum(f for f, _ in self._hist)
        lats = [t for _, t in self._hist]
        return (fails / len(self._hist), sum(lats) / len(lats))

    def on_complete(self, comp) -> None:
        step = self.store.serving_step
        if step != self._last_step:
            # a swap (or an external rollback) landed since the last
            # completion: freeze the pre-swap window as the baseline and
            # start watching the new policy
            self._base = self._freeze_baseline()
            self._watched_step = step
            self._post = []
            self._last_step = step
        self._hist.append((bool(comp.result.failed), float(comp.latency)))
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            if self._cooldown_left == 0 and self._prior_mode is not None:
                self.store.mode = self._prior_mode
                self._prior_mode = None
            return
        if self._base is None or self._watched_step is None:
            return
        self._post.append((bool(comp.result.failed), float(comp.latency)))
        if len(self._post) < self.min_post:
            return
        base_fail, base_lat = self._base
        post_fail = sum(f for f, _ in self._post) / len(self._post)
        post_lat = sum(t for _, t in self._post) / len(self._post)
        reason = None
        if post_fail > base_fail + self.fail_margin:
            reason = (f"failure rate {post_fail:.2f} > "
                      f"baseline {base_fail:.2f} + {self.fail_margin}")
        elif base_lat > 0 and post_lat > base_lat * self.latency_factor:
            reason = (f"mean latency {post_lat:.1f}s > "
                      f"{self.latency_factor}x baseline {base_lat:.1f}s")
        if reason is None:
            return
        self._trip(comp.seq, reason)

    def note_external_evidence(self, seq: int, reason: str) -> bool:
        """Opt-in alert path (serve.obs.AlertHooks): an external monitor
        attributed a live regression to the watched swap — trip NOW
        instead of waiting for `min_post` completions. Ignored (returns
        False) when no swap is under watch or a trip is already cooling
        down, so spurious alerts cannot roll back a policy the breaker
        is not even suspicious of."""
        if self._watched_step is None or self._cooldown_left > 0:
            return False
        self._trip(seq, f"external evidence: {reason}")
        return True

    def _trip(self, seq: int, reason: str) -> None:
        bad = self._watched_step
        obs = getattr(self._sched, "obs", None)
        if obs is not None:
            # emitted before the rollback so the flight-recorder dump
            # captures the pre-rollback record tail
            obs.event("breaker_trip", {"seq": seq, "step": bad,
                                       "reason": reason})
        restored = self.store.rollback(self.agent)
        self.trips.append((seq, bad, restored, reason))
        # cooldown: shadow mode — candidates keep being scored, no swaps
        if self._prior_mode is None:
            self._prior_mode = self.store.mode
        self.store.mode = "shadow"
        self._cooldown_left = self.cooldown
        # the rollback itself changes serving_step; don't treat it as a
        # fresh swap to watch
        self._last_step = self.store.serving_step
        self._base, self._watched_step, self._post = None, None, []
