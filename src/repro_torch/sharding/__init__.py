"""Sharding rules and the activation policy, as the reference's
`repro.sharding`: specs a dry run plans for, and the layout knobs the
model paths read."""
from repro_torch.sharding.rules import (P, batch_specs, cache_specs,
                                        param_specs, MeshAxes)

__all__ = ["P", "batch_specs", "cache_specs", "param_specs", "MeshAxes"]
