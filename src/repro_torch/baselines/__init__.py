"""The paper's three comparison systems, re-implemented against the same
staged engine: Spark SQL default (+AQE), Lero-style learning-to-rank over
cardinality-perturbed candidate plans, and AutoSteer-style greedy
rule-toggle search — plus the serving-shaped CBO re-plan policy
(`CboReplanAgent`) the drift benchmark probes statistics quality with."""
from repro_torch.baselines.spark_default import run_spark_default
from repro_torch.baselines.lero import LeroOptimizer
from repro_torch.baselines.autosteer import AutoSteerOptimizer
from repro_torch.baselines.cbo_serve import CboReplanAgent
