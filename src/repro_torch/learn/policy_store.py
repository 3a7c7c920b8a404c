"""Versioned policy store with a shadow-evaluation gate and atomic
hot-swap.

Every accepted policy version is committed through `repro_torch.checkpoint`
(`Checkpointer` + the shared `agent_state` layout, so offline training
checkpoints and online versions are interchangeable). Before a candidate
ever serves traffic it must pass the gate:

  1. finite-params guard — a corrupted candidate (NaN/Inf anywhere in
     actor/critic) is rejected without spending a single probe run;
  2. shadow evaluation — candidate and incumbent are both replayed
     greedy (argmax, explore=False) over a fixed held-out probe set ON
     THE LIVE DATABASE — i.e. against post-delta data, which is the
     point of re-gating after drift. Scores are mean virtual latency
     (failures already carry the timeout), so gate decisions are
     deterministic;
  3. accept iff candidate_score <= incumbent_score * (1+rel_tol)+abs_tol
     ("no worse", with slack for ties).

On accept the candidate's params are deep-copied onto the serving agent
(`install_agent_state(copy=True)` — the learner keeps donating its own
buffers to XLA, so the serving agent must never alias them) between
scheduler ticks, which is what makes the swap atomic: every query decides
all its steps against a consistent params version, and the next tick's
batch sees the new one. On reject the serving agent is untouched and
serving continues on the incumbent. `rollback` reinstalls any committed
version (newest by default) — the recourse when a swap that passed the
gate regresses later.

`mode="shadow"` evaluates and records verdicts but never swaps — a canary
mode, also used by the benchmark to price the full learning overhead
against a bit-identical serving run.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import (Checkpointer, agent_state, install_agent_state,
                              params_finite)
from repro_torch.core.rollout import rollout

log = logging.getLogger("repro_torch.learn")


class PolicyStore:
    def __init__(self, directory, probe: Sequence, *, rel_tol: float = 0.0,
                 abs_tol: float = 1e-6, keep_last: int = 5,
                 mode: str = "gate", probe_reuse_stages: bool = True):
        """probe_reuse_stages=True lets probe runs share the serving stage
        cache: results are bit-identical either way (the cache invariant),
        and repeated gates then cost near-zero host time; set False for
        fully cache-isolated evaluation."""
        assert mode in ("gate", "shadow"), mode
        self.ckpt = Checkpointer(directory, keep_last=keep_last)
        self.probe = list(probe)
        self.rel_tol, self.abs_tol = rel_tol, abs_tol
        self.mode = mode
        self.probe_reuse_stages = probe_reuse_stages
        self.versions: List[Dict] = []      # committed (accepted) versions
        self.gate_log: List[Dict] = []      # every gate verdict
        self.serving_step: Optional[int] = None
        # incumbent probe score, keyed on (serving_step, data versions):
        # it can only change after a swap/rollback or a delta, so gates in
        # between skip re-probing the incumbent
        self._inc_score: Optional[tuple] = None
        self.probe_log: List[Dict] = []     # one record per set_probe
        # optional observability sink (serve.obs.Tracer): wired by
        # whatever owns both the store and a traced scheduler (the
        # learner / breaker attach seams); None = silent
        self.obs = None

    def _emit(self, kind: str, attrs: Dict) -> None:
        if self.obs is not None:
            self.obs.event(kind, attrs)

    # ------------------------------------------------------------ probe set
    def set_probe(self, probe: Sequence, *, reason: str = "") -> None:
        """Swap the held-out probe set (the drift control plane re-samples
        it to cover drifted templates/tables instead of the fixed list).
        Invalidates the cached incumbent score: it was measured on the OLD
        probes and must not gate candidates against the new ones."""
        self.probe = list(probe)
        self._inc_score = None
        self.probe_log.append({"n": len(self.probe), "reason": reason,
                               "names": [getattr(q, "name", str(q))
                                         for q in self.probe]})

    def note_stats_refresh(self) -> None:
        """A catalog re-ANALYZE changed the Estimator the probe rollouts
        plan with (data versions did NOT move, so the version-keyed cache
        would wrongly survive): drop the cached incumbent score."""
        self._inc_score = None

    # ---------------------------------------------------------- evaluation
    def probe_score(self, agent, db, est, cluster) -> float:
        """Mean greedy virtual latency over the probe set on the live
        db (post-delta data — the point of re-gating after drift).

        Probes run at stage 3 (full action space): the gate compares the
        policies' full capability. If the serving scheduler is currently
        curriculum-restricted to a lower stage, both incumbent and
        candidate serve under the same tighter mask — the gate bounds
        capability, not the exact restricted-serving distribution."""
        lats = [rollout(db, q, est, agent, stage=3, explore=False,
                        cluster=cluster,
                        reuse_stages=self.probe_reuse_stages).result.latency
                for q in self.probe]
        return float(np.mean(lats)) if lats else 0.0

    # ------------------------------------------------------------- commits
    def commit(self, agent, step: int, extra: Optional[Dict] = None) -> int:
        """Version `agent`'s params atomically (manifest-fenced). `step`
        is a hint: if it collides with a step already on disk (e.g. a
        reused store directory from a previous run — Checkpointer.save
        silently skips existing steps), the next free step is used, so a
        commit ALWAYS writes the params it claims to. Returns the step
        actually committed."""
        step = max([self.ckpt.next_step(step)] +
                   [v["step"] + 1 for v in self.versions])
        if not self.ckpt.save(step, agent_state(agent),
                              extra=dict(extra or {})):
            raise RuntimeError(f"policy version step {step} was not "
                               f"written (step already on disk?)")
        self.versions.append({"step": step, **(extra or {})})
        self.serving_step = step
        self._emit("policy_commit", {"step": step})
        return step

    def evaluate_and_maybe_swap(self, serving_agent, candidate_agent, *,
                                db, est, cluster, step: int) -> Dict:
        """Run the gate; on accept (and mode="gate"), hot-swap the serving
        agent's params and commit the new version. Returns the verdict."""
        rec = {"step": step, "accepted": False, "swapped": False,
               "reason": "", "candidate_score": None, "incumbent_score": None}
        if not self.probe:
            # fail CLOSED: with nothing to evaluate on, "no worse" cannot
            # be demonstrated, so no candidate ever swaps in
            rec["reason"] = "empty probe set"
            self.gate_log.append(rec)
            log.info("gate@%d: REJECT (%s)", step, rec["reason"])
            self._emit("gate_eval", {"step": step, "accepted": False,
                                     "reason": rec["reason"]})
            return rec
        if not params_finite(candidate_agent):
            rec["reason"] = "non-finite candidate params"
            self.gate_log.append(rec)
            log.info("gate@%d: REJECT (%s)", step, rec["reason"])
            self._emit("gate_eval", {"step": step, "accepted": False,
                                     "reason": rec["reason"]})
            return rec
        cand = self.probe_score(candidate_agent, db, est, cluster)
        inc_key = (self.serving_step,
                   tuple(sorted(getattr(db, "versions", {}).items())))
        if self._inc_score is not None and self._inc_score[0] == inc_key:
            inc = self._inc_score[1]
        else:
            inc = self.probe_score(serving_agent, db, est, cluster)
            self._inc_score = (inc_key, inc)
        rec["candidate_score"], rec["incumbent_score"] = cand, inc
        if cand <= inc * (1.0 + self.rel_tol) + self.abs_tol:
            rec["accepted"] = True
            if self.mode == "gate":
                prior_step = self.serving_step
                install_agent_state(serving_agent,
                                    agent_state(candidate_agent), copy=True)
                rec["step"] = self.commit(serving_agent, step,
                                          extra={"probe_score": cand,
                                                 "incumbent_score": inc})
                rec["swapped"] = True
                # explicit swap marker (commit fires for offline versions
                # too): the monitor's RCA joins anomaly windows against it
                self._emit("policy_swap", {"from_step": prior_step,
                                           "to_step": rec["step"],
                                           "candidate_score": round(cand, 6),
                                           "incumbent_score": round(inc, 6)})
                # the new incumbent IS the candidate just scored
                self._inc_score = ((self.serving_step, inc_key[1]), cand)
        else:
            rec["reason"] = (f"candidate {cand:.3f}s worse than "
                             f"incumbent {inc:.3f}s")
        self.gate_log.append(rec)
        log.info("gate@%d: %s cand=%.3fs inc=%.3fs%s", step,
                 "ACCEPT" if rec["accepted"] else "REJECT", cand, inc,
                 " (shadow)" if self.mode == "shadow" else "")
        self._emit("gate_eval", {
            "step": rec["step"], "accepted": rec["accepted"],
            "swapped": rec["swapped"], "reason": rec["reason"],
            "candidate_score": round(cand, 6),
            "incumbent_score": round(inc, 6)})
        return rec

    # ------------------------------------------------------------ rollback
    def rollback(self, agent, step: Optional[int] = None) -> int:
        """Reinstall a committed version. Default: the newest version
        BEFORE the one currently serving (the newest overall would be the
        just-regressed version itself); falls back to the newest valid
        checkpoint when no prior one survives retention."""
        if step is None and self.serving_step is not None:
            prior = [s for s in self.ckpt.steps() if s < self.serving_step]
            if prior:
                step = max(prior)
        tree, s, _ = self.ckpt.restore(agent_state(agent), step)
        install_agent_state(agent, tree, copy=True)
        prior = self.serving_step
        self.serving_step = s
        log.info("rollback: serving policy restored to step %d", s)
        self._emit("policy_rollback", {"from_step": prior, "to_step": s})
        return s

    def stats(self) -> Dict:
        return {"mode": self.mode, "n_versions": len(self.versions),
                "n_gates": len(self.gate_log),
                "n_accepted": sum(g["accepted"] for g in self.gate_log),
                "serving_step": self.serving_step}
