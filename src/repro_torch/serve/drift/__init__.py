"""Drift control plane: staleness as a measured, managed quantity.

The serving stack treats optimizer-statistics staleness as a
fixed fact — `analyze()` runs once, the QoS predictor is calibrated
one-shot, the policy-store gate probes a fixed list. This package closes
the remaining loop: DETECT how stale each table's statistics actually
are, then spend background cycles correcting whichever model of the data
drifted — the catalog, the latency predictor, or the gate's probe
coverage. Four cooperating pieces:

  detector.py    `DriftDetector` — per-table staleness scores fusing
                 catalog lag (`Database.versions` bumps + live/believed
                 row ratio), harvested latency regret (original replay), and
                 predicted-vs-actual latency error (original predictor).

  policy.py      `RefreshPolicy` — never / always / threshold / budgeted
                 re-ANALYZE policies; "never" is the paper's stale-stats
                 premise as the bit-identical baseline, the rest make
                 re-ANALYZE a benchmarked tradeoff (modeled cost
                 deterministic, wall cost reported).

  probes.py      `CoverageProbeSet` — re-samples the policy-store gate's
                 held-out probes to cover drifted templates/tables
                 instead of a fixed list.

  controller.py  `DriftController` — the scheduler hook tying it
                 together: feeds the detector per completion, schedules
                 incremental `catalog.analyze_table` runs as write-
                 barrier tasks (`LaneScheduler.schedule_barrier`),
                 refits the predictor from the live replay buffer
                 (generation-fenced), installs re-covered probe sets.

Everything decides from virtual-clock state, modeled costs and seeded
RNGs, so serving with the control plane attached stays bit-reproducible;
`benchmarks/bench_drift.py` sweeps refresh-policy x predictor-refresh
arms under a drifting delta workload. See serve/README.md for the
dataflow diagram.
"""
from repro_torch.serve.drift.controller import DriftController, DriftStats
from repro_torch.serve.drift.detector import DriftDetector, TableDrift
from repro_torch.serve.drift.policy import RefreshDecision, RefreshPolicy
from repro_torch.serve.drift.probes import CoverageProbeSet

__all__ = [
    "DriftController", "DriftStats",
    "DriftDetector", "TableDrift",
    "RefreshDecision", "RefreshPolicy",
    "CoverageProbeSet",
]
