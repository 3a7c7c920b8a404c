"""sample_world: one seed -> a complete runnable world.

The top of the generator stack: derives independent sub-seeds for each
layer via `seeds.substream` (schema / data / queries / stream / faults),
then runs the layered samplers:

    spec     = schema.sample_schema(substream(seed, 1))
    db       = datagen.make_db_from_spec(spec, seed=substream(seed, 2))
    workload = queries.make_gen_workload(spec, substream(seed, 3) % GAP)
    stream   = streams.build_stream(workload, profile, substream(seed, 4))

so same world seed => bit-identical everything, and any layer can be
resampled independently (e.g. many data seeds over one schema, or many
streams over one workload) by fixing the others' sub-seeds.

`World.meta` is the `WorkloadMeta` the serving agent encodes against;
for cross-schema serving (train on world A, serve world B) keep A's
meta — B's unseen tables encode as all-zero bits (§V-B2), which is
exactly the generalization question `benchmarks/bench_generalize.py`
measures.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.encoding import WorkloadMeta
from repro_torch.gen import schema, streams
from repro_torch.gen.queries import make_gen_workload
from repro_torch.gen.seeds import TRAIN_TEST_SEED_GAP, substream
from repro_torch.gen.spec import SchemaSpec
from repro_torch.serve.scheduler import Arrival
from repro_torch.sql import datagen
from repro_torch.sql.workloads import Workload

__all__ = ["World", "sample_world"]

# substream stage tags (stable: changing one resamples ONLY that layer)
STAGE_SCHEMA, STAGE_DATA, STAGE_QUERIES, STAGE_STREAM, STAGE_FAULTS = \
    1, 2, 3, 4, 5


@dataclasses.dataclass
class World:
    seed: int
    spec: SchemaSpec
    db: object                         # None when materialize=False
    workload: Workload
    meta: WorkloadMeta
    stream: List[Arrival]              # [] when with_stream=False
    profile: Optional[streams.StreamProfile]

    def fault_injector(self):
        """The world's sampled chaos (None for fault-free profiles)."""
        if self.profile is None:
            return None
        return streams.make_fault_injector(
            self.profile, substream(self.seed, STAGE_FAULTS))


def sample_world(seed: int, *, family: Optional[str] = None,
                 scale: float = 0.05, n_templates: int = 8,
                 n_train: int = 16, n_test_per_template: int = 1,
                 t_min: int = 3, t_max: int = 7, n_queries: int = 30,
                 materialize: bool = True,
                 with_stream: bool = True) -> World:
    """Sample one world. `materialize=False` skips building the database
    (schema/workload-only property tests over hundreds of worlds);
    `with_stream=False` skips the arrival stream."""
    spec = schema.sample_schema(substream(seed, STAGE_SCHEMA),
                                family=family)
    db = None
    if materialize:
        db = datagen.make_db_from_spec(spec, scale=scale,
                                       seed=substream(seed, STAGE_DATA))
    base = substream(seed, STAGE_QUERIES) % TRAIN_TEST_SEED_GAP
    workload = make_gen_workload(spec, base, n_templates=n_templates,
                                 n_train=n_train,
                                 n_test_per_template=n_test_per_template,
                                 t_min=t_min, t_max=t_max)
    meta = WorkloadMeta.from_workload(workload)
    profile = None
    stream: List[Arrival] = []
    if with_stream:
        stream_seed = substream(seed, STAGE_STREAM)
        profile = streams.sample_profile(spec, stream_seed,
                                         n_queries=n_queries)
        stream = streams.build_stream(workload, profile, stream_seed)
    return World(seed=seed, spec=spec, db=db, workload=workload, meta=meta,
                 stream=stream, profile=profile)
