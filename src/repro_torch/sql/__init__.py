"""Staged Spark-like engine: catalog, data generator, workloads, plans,
cluster model, cost-based optimizer and the resumable executor."""
