"""Reads the reference's checkpoints (`MANIFEST.json` + one `.npy` per
leaf, each with the sha1 of its bytes) and carries its parameter trees
across to the port's networks."""
from repro_torch.checkpoint.reference import (load_reference_checkpoint,
                                              params_from_numpy)

__all__ = ["load_reference_checkpoint", "params_from_numpy"]
