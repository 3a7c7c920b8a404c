"""Adaptive curriculum: the paper's staged action-space schedule, driven
by live serving statistics instead of an episode counter.

Offline training promotes through stages 1→2→3 at fixed episode
fractions (`core.actions.curriculum_stage`). Online there is no episode
horizon — the loop promotes when the SERVING stream says the policy has
earned the next stage: a rolling window of completions must clear a
success-rate threshold (and optionally a p50-latency ceiling) and the
current stage must have been held for a minimum dwell. Stage 1 restricts
the mask to the safe pre-execution family (cbo/no-op), stage 2 unlocks
runtime plan adjustments, stage 3 lifts every restriction — so a cold or
freshly-swapped policy cannot take destabilizing actions on live traffic
until its own track record licenses them. Optionally the governor also
runs in reverse: a window whose success rate collapses (drift starting
to fail queries) demotes a stage, re-restricting the action space and —
through `BackgroundLearner.explore_below_stage` — re-opening exploration
until the loop has adapted and the track record re-earns stage 3.

`observe` is called once per completion (the `BackgroundLearner` wires it
to the scheduler's completion hook and copies `stage` onto the scheduler
between ticks); everything is computed from virtual-clock quantities, so
promotion points are bit-reproducible.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


class AdaptiveCurriculum:
    def __init__(self, *, start_stage: int = 1, window: int = 16,
                 promote_success: float = 0.9,
                 promote_p50: Optional[float] = None,
                 min_dwell: int = 16,
                 demote_success: Optional[float] = None,
                 drift_demote_threshold: Optional[float] = None,
                 drift_cooldown: Optional[int] = None):
        """window           rolling completion window the thresholds see
        promote_success  fraction of window completions that must succeed
        promote_p50      optional ceiling on the window's p50 latency (s)
        min_dwell        completions that must pass before each promotion
        demote_success   optional floor: a full window whose success rate
                         falls below it DEMOTES one stage — the governor
                         that re-restricts the action space (and, via the
                         learner's explore gating, re-opens exploration)
                         when drift starts failing queries
        drift_demote_threshold
                         optional `DriftDetector` peak-score trigger for
                         `note_drift`: demote PROACTIVELY on attributed
                         drift (catalog lag, regret, prediction error)
                         rather than waiting for a window of failures —
                         the success-rate governor is reactive; this one
                         re-restricts the action space as soon as the
                         detector says the world moved
        drift_cooldown   completions between drift demotions (default:
                         `window`), so one sustained drift episode costs
                         at most one stage per window
        """
        assert 1 <= start_stage <= 3
        self.stage = start_stage
        self.window_size = window
        self.promote_success = promote_success
        self.promote_p50 = promote_p50
        self.min_dwell = min_dwell
        self.demote_success = demote_success
        self.drift_demote_threshold = drift_demote_threshold
        self.drift_cooldown = window if drift_cooldown is None \
            else drift_cooldown
        self._last_drift_demote = -(1 << 30)
        self._window: Deque[Tuple[bool, float]] = deque(maxlen=window)
        self._dwell = 0
        self.n_observed = 0
        self.promotions: List[int] = []    # completion counts at promotion
        self.demotions: List[int] = []     #   ... and at demotion
        self.drift_demotions: List[int] = []  # subset driven by note_drift

    def observe(self, comp) -> int:
        """Fold one scheduler Completion in; returns the (possibly just
        promoted/demoted) current stage."""
        self.n_observed += 1
        self._dwell += 1
        self._window.append((not comp.result.failed, comp.result.latency))
        if self.stage > 1 and self.demote_success is not None and \
                len(self._window) >= self.window_size and \
                self._success_rate() < self.demote_success:
            self.stage -= 1
            self.demotions.append(self.n_observed)
            self._dwell = 0
            self._window.clear()
        elif self.stage < 3 and self._ready():
            self.stage += 1
            self.promotions.append(self.n_observed)
            self._dwell = 0
            self._window.clear()
        return self.stage

    def note_drift(self, peak_score: float) -> bool:
        """Detector-driven demotion (wired by `drift.DriftController`):
        when the peak per-table drift score crosses the configured
        threshold, drop one stage immediately — stale-stats drift makes
        the aggressive action families the riskiest exactly when the
        track record that earned them stops being evidence. Window and
        dwell reset, so re-promotion must be re-earned on post-drift
        traffic. Returns True when a demotion fired."""
        if self.drift_demote_threshold is None or \
                peak_score < self.drift_demote_threshold:
            return False
        if self.stage <= 1 or \
                self.n_observed - self._last_drift_demote < \
                self.drift_cooldown:
            return False
        self.stage -= 1
        self.demotions.append(self.n_observed)
        self.drift_demotions.append(self.n_observed)
        self._last_drift_demote = self.n_observed
        self._dwell = 0
        self._window.clear()
        return True

    def _success_rate(self) -> float:
        return float(np.mean([s for s, _ in self._window]))

    def _ready(self) -> bool:
        if self._dwell < self.min_dwell or \
                len(self._window) < self.window_size:
            return False
        if self._success_rate() < self.promote_success:
            return False
        if self.promote_p50 is not None:
            lat = np.asarray([l for _, l in self._window])
            if float(np.percentile(lat, 50)) > self.promote_p50:
                return False
        return True

    def stats(self) -> dict:
        return {"stage": self.stage, "observed": self.n_observed,
                "promotions": list(self.promotions),
                "demotions": list(self.demotions),
                "drift_demotions": list(self.drift_demotions)}
