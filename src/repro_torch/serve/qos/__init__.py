"""QoS control plane: SLO-aware multi-tenant serving on top of the lane
scheduler.

The serving tier decides *which plan* each query runs; the
lifelong loop decides *what the policy knows*; this package
decides *whether and how hard* each query gets re-optimized under
latency SLOs and tenant contention. Four cooperating pieces:

  tenancy.py    `TenantRegistry`: per-tenant token-bucket rate limits on
                the virtual clock, weighted fair-share lane accounting,
                default SLOs, cache partition budgets.

  predictor.py  `LatencyPredictor`: a critic-shaped jitted net over the
                encoded syntactic plan (warm-startable from the serving
                agent's value head, trained from harvested latencies via
                the original replay buffer) predicting query latency at
                admission time.

  degrade.py    `DegradationLadder`: predicted-miss severity -> shrunken
                re-optimization hook budget (down to the pure
                syntactic/AQE plan) or rejection.

  admission.py  `AdmissionPolicy` (FCFS pass-through base) and
                `QoSAdmission`: token-bucket deferral, EDF + fair-share
                selection, predictor-vs-deadline rejection, ladder
                degradation — plugged into `LaneScheduler(admission=…)`.

Everything runs on the deterministic virtual clock with seeded RNGs, so
QoS decisions are bit-reproducible; with no admission policy installed
the scheduler is bit-identical to the original async path.
"""
from repro_torch.serve.qos.admission import (AdmissionDecision, AdmissionPolicy,
                                       EdfPolicy, QoSAdmission)
from repro_torch.serve.qos.degrade import DegradationLadder, DegradeDecision
from repro_torch.serve.qos.predictor import LatencyPredictor, encode_query
from repro_torch.serve.qos.tenancy import TenantRegistry, TenantSpec

__all__ = [
    "AdmissionDecision", "AdmissionPolicy", "EdfPolicy", "QoSAdmission",
    "DegradationLadder", "DegradeDecision",
    "LatencyPredictor", "encode_query",
    "TenantRegistry", "TenantSpec",
]
