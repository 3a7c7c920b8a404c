"""AQORA agent, inference surface: TreeCNN actor + critic, masked greedy
policy.

The serving stack duck-types the agent through `meta`, `space`, `cfg`
and `act_batch` (serve/scheduler.py); rollouts also use `act_keyed` and
`act`. `act_batch` trims the node dimension to the workload's bucket,
runs the encoder (the fused CUDA kernel on the card), the head, the
-1e9 action mask and a log-softmax, takes the argmax, and copies
actions and log-probabilities to the host in ONE device->host transfer;
the lane keys advance on the host with the reference's threefry split.

Not ported yet: exploration sampling (bit-exact `jax.random.categorical`,
ROADMAP Queue A5), and the PPO update, `clone` and the AdamW states,
which come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import nets
from repro_torch.core.actions import ActionSpace
from repro_torch.core.encoding import MAX_NODES, WorkloadMeta
from repro_torch.core.prng import split


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    net: str = "treecnn"               # treecnn | lstm | fcnn | queryformer
    hidden: int = 96
    head_hidden: int = 96
    families: Tuple[str, ...] = ("cbo", "lead", "noop")
    max_steps: int = 3                 # hook interventions per query (§VI-A)
    ppo_epochs: int = 6
    clip: float = 0.2
    entropy: float = 0.02              # η
    gamma: float = 1.0                 # Alg. 1 sets γ=1
    lr_actor: float = 3e-4
    lr_critic: float = 1e-3
    curriculum: Tuple[float, float] = (0.25, 0.55)
    failure_penalty: float = 300.0     # R(τ) -= sqrt(300) on failure
    fused_treecnn: bool = False        # the reference's switch for its
                                       #   fused TPU kernel; the port's
                                       #   encoder takes its kernel on CUDA
                                       #   either way


def _node_bucket(n_used: int) -> int:
    """Smallest multiple of 16 covering the deepest used node slot.

    A plan tree over n relations has at most 2n-1 nodes (+ the null slot),
    and encode_state numbers them contiguously from 1, so every state of a
    workload fits in one trimmed node dimension — ONE compiled shape per
    batch size instead of always paying the full MAX_NODES padding."""
    b = 16
    while b < n_used:
        b += 16
    return min(b, MAX_NODES)


def _explore_unported():
    return NotImplementedError(
        "explore=True needs bit-exact jax.random.categorical sampling, "
        "which is not ported yet (ROADMAP Queue A5)")


class AqoraAgent:
    """`device=None` means CUDA, and raises when no CUDA device exists;
    pass `device="cpu"` for the plain PyTorch path. On the card the
    batched TreeCNN goes through the fused kernel whatever
    `cfg.fused_treecnn` says: the reference holds both settings to the
    same numbers."""

    def __init__(self, meta: WorkloadMeta, cfg: AgentConfig = AgentConfig(),
                 seed: int = 0, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "AqoraAgent runs on CUDA by default and no CUDA device "
                    "is available; pass device='cpu' for the plain path")
            device = "cuda"
        if cfg.net != "treecnn":
            raise NotImplementedError(
                f"encoder {cfg.net!r} is not ported yet; only treecnn is")
        self.device = torch.device(device)
        self.meta = meta
        self.cfg = cfg
        self.space = ActionSpace(meta.n_tables_max, cfg.families)
        gen = torch.Generator().manual_seed(seed)
        F, H = meta.feat_dim, cfg.hidden
        self.actor = nets.EncoderHead(F, H, cfg.head_hidden, self.space.d,
                                      gen).to(self.device)
        self.critic = nets.EncoderHead(F, H, cfg.head_hidden, 1,
                                       gen).to(self.device)
        # static per-workload trimmed node dim
        self._nodes = _node_bucket(2 * meta.n_tables_max)

    def load_params(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Install `checkpoint.params_from_numpy` output (actor + critic)."""
        self.actor.load_state_dict(state["actor"])
        self.critic.load_state_dict(state["critic"])

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------- policy
    @torch.inference_mode()
    def policy_probs(self, enc_state, amask: np.ndarray) -> np.ndarray:
        lg = self.actor(*(self._tensor(x) for x in enc_state))
        lg = lg.masked_fill(~(self._tensor(amask) > 0), -1e9)
        return torch.softmax(lg, dim=-1).cpu().numpy()

    def act(self, enc_state, amask: np.ndarray,
            explore: bool = True) -> Tuple[int, float]:
        if explore:
            raise _explore_unported()
        probs = self.policy_probs(enc_state, amask)
        a = int(np.argmax(probs))
        return a, float(np.log(max(probs[a], 1e-12)))

    @torch.inference_mode()
    def act_batch(self, feat, left, right, mask, amask, keys,
                  explore: bool = True):
        """Act for B lanes: feat (B, N, F), left/right (B, N) int32, mask
        (B, N), amask (B, d), keys (B, 2) uint32. Returns numpy (actions
        (B,) int32, logps (B,) float32, advanced keys (B, 2) uint32).

        The node dimension is trimmed to the workload's bucket first:
        trailing padding rows never influence real nodes, so this is
        exact."""
        if explore:
            raise _explore_unported()
        mask = np.asarray(mask)
        n = min(self._nodes, _node_bucket(int(mask.sum(axis=1).max()) + 1))
        lg = self.actor(self._tensor(np.asarray(feat)[:, :n]),
                        self._tensor(np.asarray(left)[:, :n]),
                        self._tensor(np.asarray(right)[:, :n]),
                        self._tensor(mask[:, :n]))
        lg = lg.masked_fill(~(self._tensor(amask) > 0), -1e9)
        logp_all = torch.log_softmax(lg, dim=-1)
        a = lg.argmax(dim=-1)
        logp = logp_all.gather(1, a[:, None])[:, 0]
        host = torch.stack([a.to(torch.float32), logp]).cpu().numpy()
        return host[0].astype(np.int32), host[1], split(keys)[:, 0]

    def act_keyed(self, enc_state, amask: np.ndarray, key,
                  explore: bool = True) -> Tuple[int, float, np.ndarray]:
        """Serial act with an explicit PRNG key chain — one lane of
        act_batch. Returns (action, logp, advanced key)."""
        feat, left, right, mask = enc_state
        a, logp, new_keys = self.act_batch(
            feat[None], left[None], right[None], mask[None],
            np.asarray(amask)[None], np.asarray(key, np.uint32)[None],
            explore=explore)
        return int(a[0]), float(logp[0]), new_keys[0]

    @torch.inference_mode()
    def value(self, enc_state) -> float:
        return float(self.critic(*(self._tensor(x) for x in enc_state))[0])

    def param_count(self) -> int:
        return sum(p.numel() for net in (self.actor, self.critic)
                   for p in net.parameters())
