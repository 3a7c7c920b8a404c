"""Seeded world generator: random schemas, workloads and delta streams.

Layered samplers, each a pure function of its seed:

  spec      the schema grammar (`SchemaSpec`) + validity checks
  seeds     the disjoint train/test seed-partition contract
  schema    `SchemaSampler`: star/snowflake/person-centric FK DAGs
  queries   `QuerySampler`: acyclic join templates over a spec's FK graph
  streams   `StreamSampler`: mixed delta/tenant/fault arrival streams
  world     `sample_world`: one seed -> (spec, db, workload, stream)

Only the dependency-free layers are imported eagerly (``sql.datagen``
imports ``repro_torch.gen.spec``, which triggers this package ``__init__`` —
pulling the serve-layer samplers in here would cycle back through
``serve.deltas`` into ``sql.datagen``). Import the samplers from their
modules: ``from repro_torch.gen.world import sample_world``.
"""
from repro_torch.gen import seeds, spec                              # noqa: F401
from repro_torch.gen.spec import (ColumnSpec, SchemaSpec, TableSpec,  # noqa: F401
                            assert_valid, delete_safe_tables, join_edges)

__all__ = ["seeds", "spec", "ColumnSpec", "SchemaSpec", "TableSpec",
           "assert_valid", "delete_safe_tables", "join_edges"]
