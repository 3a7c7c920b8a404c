"""DQN variant of the decision model (Fig. 11(a) ablation), in PyTorch
(the reference's is `repro/core/dqn.py`).

Same TreeCNN encoder and action space as the PPO agent, but value-based:
epsilon-greedy behaviour policy, experience replay over (s, a, r, s',
mask', done) transitions, and a periodically-synced target network. The
paper finds DQN converges slower and plateaus worse in this large,
non-stationary action space — the benchmark reproduces that comparison.

The Q-network is `nets.EncoderHead` from the reference's keys, so a seed
gives its weights bit for bit; on the card its TreeCNN is the fused
forward kernel (one launch an `act`, at B = 1 and N = MAX_NODES) and its
backward kernel. A train step runs the Q-network and the target over
the sampled batch (B = 64, N = MAX_NODES: two forward launches), one
backward and one step of the hand-written AdamW, in place. Because that
step writes the Q-network's parameters in place, the target is a deep
copy, made at init and at each sync (the reference's `tree_map(lambda x:
x, ...)` aliases immutable jax arrays). Exploration and replay draws come
from `np.random.default_rng(seed + 1)` in the reference's order.
"""
from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import Deque, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import nets, prng
from repro_torch.core.actions import ActionSpace
from repro_torch.core.agent import AgentConfig, param_tree, resolve_device
from repro_torch.core.encoding import WorkloadMeta
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import nest


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    hidden: int = 96
    head_hidden: int = 96
    gamma: float = 1.0
    eps_start: float = 0.9
    eps_end: float = 0.05
    eps_decay_episodes: int = 150
    buffer_size: int = 4096
    batch_size: int = 64
    target_sync: int = 20              # episodes
    lr: float = 5e-4


class DQNAgent:
    """Duck-types AqoraAgent's act/update interface for the rollout loop.
    `device=None` means CUDA, and raises when no CUDA device exists."""

    def __init__(self, meta: WorkloadMeta, cfg: AgentConfig = AgentConfig(),
                 dqn: DQNConfig = DQNConfig(), seed: int = 0, device=None):
        self.device = resolve_device(device, "DQNAgent")
        self.meta, self.cfg, self.dcfg = meta, cfg, dqn
        self.space = ActionSpace(meta.n_tables_max, cfg.families)
        k = prng.split(prng.prng_key(seed), 2)
        F, H = meta.feat_dim, dqn.hidden
        self.qnet = nets.EncoderHead(F, H, dqn.head_hidden, self.space.d,
                                     k[0], k[1]).to(self.device)
        self.target = copy.deepcopy(self.qnet)
        self.opt = adamw_init(param_tree(self.qnet))
        self._ocfg = AdamWConfig(lr=dqn.lr, weight_decay=0.0, grad_clip=5.0)
        self.buffer: Deque = deque(maxlen=dqn.buffer_size)
        self.episode = 0
        self.rng = np.random.default_rng(seed + 1)

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.inference_mode()
    def _q(self, enc_state) -> np.ndarray:
        return self.qnet(*(self._tensor(x) for x in enc_state)).cpu().numpy()

    # ---- rollout interface (duck-typed with AqoraAgent)
    def act(self, enc_state, amask, explore=True) -> Tuple[int, float]:
        d = self.dcfg
        eps = max(d.eps_end, d.eps_start - (d.eps_start - d.eps_end)
                  * self.episode / d.eps_decay_episodes)
        legal = np.flatnonzero(amask > 0)
        if explore and self.rng.random() < eps:
            return int(self.rng.choice(legal)), 0.0
        q = np.array(self._q(enc_state))
        q[amask <= 0] = -1e9
        return int(np.argmax(q)), 0.0

    def value(self, enc_state) -> float:
        return float(np.max(self._q(enc_state)))

    # ---- learning
    def record(self, traj):
        """Push (s, a, r, s', amask', done); the terminal reward folds
        -sqrt(T) into the last transition."""
        k = len(traj.actions)
        term = -float(np.sqrt(traj.t_execute))
        for t in range(k):
            s = traj.states[t]
            done = t == k - 1 or t + 1 >= len(traj.states)
            s2 = traj.states[min(t + 1, len(traj.states) - 1)]
            am2 = traj.masks[min(t + 1, len(traj.masks) - 1)]
            r = traj.rewards[t] + (term if done else 0.0)
            self.buffer.append((s, traj.actions[t], r, s2, am2, float(done)))

    def _loss(self, b) -> torch.Tensor:
        q = self.qnet(b["feat"], b["left"], b["right"], b["mask"])
        qa = q.gather(1, b["action"][:, None])[:, 0]
        with torch.no_grad():
            qn = self.target(b["nfeat"], b["nleft"], b["nright"], b["nmask"])
            qn = qn.masked_fill(~(b["namask"] > 0), -1e9)
            tgt = b["reward"] + self.dcfg.gamma * qn.amax(dim=-1) * \
                (1 - b["done"])
        return torch.mean((qa - tgt) ** 2)

    def train_step(self) -> float:
        d = self.dcfg
        if len(self.buffer) < d.batch_size:
            return 0.0
        idx = self.rng.choice(len(self.buffer), size=d.batch_size, replace=False)
        rows = [self.buffer[i] for i in idx]

        def stack(sel):
            return [self._tensor(np.stack([r[sel][j] for r in rows]))
                    for j in range(4)]

        f, l, rr, m = stack(0)
        nf, nl, nr, nm = stack(3)
        batch = {"feat": f, "left": l, "right": rr, "mask": m,
                 "action": self._tensor(np.array([r[1] for r in rows],
                                                 np.int64)),
                 "reward": self._tensor(np.array([r[2] for r in rows],
                                                 np.float32)),
                 "nfeat": nf, "nleft": nl, "nright": nr, "nmask": nm,
                 "namask": self._tensor(np.stack([r[4] for r in rows])
                                        .astype(np.float32)),
                 "done": self._tensor(np.array([r[5] for r in rows],
                                               np.float32))}
        loss = self._loss(batch)
        named = dict(self.qnet.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        adamw_update(nest(named), nest(dict(zip(named, grads))), self.opt,
                     self._ocfg)
        return float(loss.detach())

    def end_episode(self):
        self.episode += 1
        if self.episode % self.dcfg.target_sync == 0:
            self.target = copy.deepcopy(self.qnet)

    # PPO-interface shim so train_loop can drive either agent
    def ppo_update(self, traj) -> Dict[str, float]:
        self.record(traj)
        losses = [self.train_step() for _ in range(4)]
        self.end_episode()
        return {"actor_loss": float(np.mean(losses)), "critic_loss": 0.0}

    def param_count(self) -> int:
        return sum(p.numel() for p in self.qnet.parameters())
