"""One serialization path for agent parameters, as the reference's
`repro/checkpoint/agent_io.py`.

`agent_state` gathers an AQORA agent's learnable state (actor and critic
parameters plus both AdamW states) into one nested dict whose leaf paths
are the reference's ("actor/enc/conv1/wr", "aopt/m/head/w2",
"aopt/step"), so `Checkpointer` writes the reference's layout and a
checkpoint restores on either side; `install_agent_state` puts such a
tree back onto a live agent.

`install_agent_state` deep-copies by default (`copy=True`, the
reference's keyword): the PPO update writes the parameters and moments
in place, so a source and its target must not share tensors. Parameters
always go into the agent's own `nn.Parameter`s, and the AdamW tensors
onto its device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.agent import param_tree
from repro_torch.tree import leaves, tree_map


def agent_state(agent) -> Dict:
    """The agent's full learnable state as one tree (no copies)."""
    return {"actor": param_tree(agent.actor),
            "critic": param_tree(agent.critic),
            "aopt": agent.aopt, "copt": agent.copt}


def install_agent_state(agent, tree: Dict, copy: bool = True) -> None:
    """Put `tree` (from `agent_state`, `Checkpointer.restore` or
    `reference.agent_state_from_numpy`) onto `agent`. Parameters are
    written into the agent's own `nn.Parameter`s either way. With
    copy=True (default) the AdamW tensors are copied too, so no tensor of
    `tree` is shared with the agent afterwards; with copy=False an AdamW
    tensor already on the agent's device is taken as it is."""
    dev = agent.device
    with torch.no_grad():
        for net in ("actor", "critic"):
            tree_map(lambda p, x: p.copy_(torch.as_tensor(x)),
                     param_tree(getattr(agent, net)), tree[net])

    def opt(x):
        return torch.as_tensor(x).to(dev, copy=copy)
    agent.aopt = tree_map(opt, tree["aopt"])
    agent.copt = tree_map(opt, tree["copt"])


def params_finite(agent) -> bool:
    """Cheap sanity gate: every actor/critic leaf is finite."""
    return all(bool(torch.isfinite(p).all())
               for net in (agent.actor, agent.critic)
               for p in leaves(param_tree(net)))
