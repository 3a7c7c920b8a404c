"""Spark SQL default configuration (+AQE): the most common industrial
practice (§VII-A3a). CBO is off by default in Spark, so the join order is
the SQL text's syntactic order; AQE performs runtime SMJ->BHJ switching and
partition coalescing. No optimization-time overhead is charged (§VII-B2).
"""
from __future__ import annotations

from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel
from repro_torch.sql.executor import RunResult, annotate_methods, run_adaptive
from repro_torch.sql.plans import syntactic_plan


def run_spark_default(db, query, est: Estimator,
                      cluster: ClusterModel = ClusterModel()) -> RunResult:
    plan = annotate_methods(syntactic_plan(query), query, est, cluster)
    return run_adaptive(db, query, plan, est, cluster, hook=None)
