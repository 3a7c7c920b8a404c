"""The agent's state and checkpoints in the reference's layout: reads the
reference's checkpoints (`MANIFEST.json` + one `.npy` per leaf, each with
the sha1 of its bytes), carries its trees across to the port's networks
and AdamW states, and writes the same layout (`Checkpointer`)."""
from repro_torch.checkpoint.agent_io import (agent_state,
                                             install_agent_state,
                                             params_finite)
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.reference import (agent_state_from_numpy,
                                              agent_state_to_numpy,
                                              lm_params_from_numpy,
                                              load_reference_checkpoint,
                                              params_from_numpy)

__all__ = ["Checkpointer", "agent_state", "agent_state_from_numpy",
           "agent_state_to_numpy", "install_agent_state",
           "lm_params_from_numpy", "load_reference_checkpoint",
           "params_finite", "params_from_numpy"]
