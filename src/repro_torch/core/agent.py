"""AQORA agent: actor + critic (TreeCNN by default, or the LSTM, FCNN or
QueryFormer encoder of `cfg.net`), masked policy, PPO update (Alg. 1).

The serving stack duck-types the agent through `meta`, `space`, `cfg`
and `act_batch` (serve/scheduler.py); rollouts also use `act_keyed` and
`act`. `act_batch` trims the node dimension to the workload's bucket,
runs the encoder (the fused CUDA kernel on the card), the head, the
-1e9 action mask and a log-softmax, and picks each lane's action: the
argmax, or with `explore` the reference's `jax.random.categorical` draw
from the lane's subkey (`prng.categorical`: uniforms made on the host,
Gumbel-argmax on the device). Actions and log-probabilities come to the
host in ONE device->host transfer; the lane keys advance on the host
with the reference's threefry split. Serial `act` samples with
`prng.choice` from the agent's own key chain, as the reference's
`jax.random.choice`. The FCNN flattens all MAX_NODES slots, so its
states are never trimmed; for the others trimming is exact (masked LSTM
steps keep their state, padded QueryFormer keys get -1e9).

`ppo_update_batch` is the reference's update: realised returns and the
current critic's values on the host side, then `cfg.ppo_epochs` epochs
of clipped PPO (actor) and masked MSE (critic), each with its own
backward (through the fused encoder's backward kernel on the card) and
its own step of the hand-written AdamW (`repro_torch.optim`), in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import nets, prng
from repro_torch.core.actions import ActionSpace
from repro_torch.core.encoding import MAX_NODES, WorkloadMeta
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import nest


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
                                       #   encoder (inference and PPO
                                       #   losses) takes its forward and
                                       #   backward kernels on CUDA either
                                       #   way


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


def resolve_device(device, who: str) -> torch.device:
    """`device`, where None means CUDA and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain path")
        device = "cuda"
    return torch.device(device)


def param_tree(net: torch.nn.Module):
    """A network's parameters as the reference's nested dict
    ({"enc": {"conv1": {"wr": ...}}, "head": {...}}), the tensors
    themselves (no copies)."""
    return nest(dict(net.named_parameters()))


class AqoraAgent:
    """`device=None` means CUDA, and raises when no CUDA device exists;
    pass `device="cpu"` for the plain PyTorch path. On the card the
    batched TreeCNN goes through the fused kernel whatever
    `cfg.fused_treecnn` says: the reference holds both settings to the
    same numbers."""

    def __init__(self, meta: WorkloadMeta, cfg: AgentConfig = AgentConfig(),
                 seed: int = 0, device=None):
        self.device = resolve_device(device, "AqoraAgent")
        self.meta = meta
        self.cfg = cfg
        self.space = ActionSpace(meta.n_tables_max, cfg.families)
        # the reference's keys; weights drawn on the host, then moved
        k = prng.split(prng.prng_key(seed), 5)
        F, H = meta.feat_dim, cfg.hidden
        self.actor = nets.EncoderHead(F, H, cfg.head_hidden, self.space.d,
                                      k[0], k[1], cfg.net).to(self.device)
        self.critic = nets.EncoderHead(F, H, cfg.head_hidden, 1,
                                       k[2], k[3], cfg.net).to(self.device)
        self.aopt = adamw_init(param_tree(self.actor))
        self.copt = adamw_init(param_tree(self.critic))
        self._acfg = AdamWConfig(lr=cfg.lr_actor, weight_decay=0.0,
                                 grad_clip=5.0)
        self._ccfg = AdamWConfig(lr=cfg.lr_critic, weight_decay=0.0,
                                 grad_clip=5.0)
        self.rng = prng.prng_key(seed + 1)
        # static per-workload trimmed node dim (fcnn flattens MAX_NODES)
        self._nodes = MAX_NODES if cfg.net == "fcnn" \
            else _node_bucket(2 * meta.n_tables_max)

    def load_params(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Install `checkpoint.params_from_numpy` output (actor + critic)."""
        self.actor.load_state_dict(state["actor"])
        self.critic.load_state_dict(state["critic"])

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _trim(self, used) -> int:
        """The node dimension for states with `used` masked-in slots: the
        bucket of the deepest, or MAX_NODES for fcnn."""
        if self.cfg.net == "fcnn":
            return MAX_NODES
        return min(self._nodes, _node_bucket(int(np.max(used)) + 1))

    # ------------------------------------------------------------- policy
    @torch.inference_mode()
    def policy_probs(self, enc_state, amask: np.ndarray) -> np.ndarray:
        lg = self.actor(*(self._tensor(x) for x in enc_state))
        lg = lg.masked_fill(~(self._tensor(amask) > 0), -1e9)
        return torch.softmax(lg, dim=-1).cpu().numpy()

    def act(self, enc_state, amask: np.ndarray,
            explore: bool = True) -> Tuple[int, float]:
        probs = self.policy_probs(enc_state, amask)
        if explore:
            self.rng, k = prng.split(self.rng)
            a = prng.choice(k, len(probs), probs)
        else:
            a = int(np.argmax(probs))
        return a, float(np.log(max(probs[a], 1e-12)))

    @torch.inference_mode()
    def act_batch(self, feat, left, right, mask, amask, keys,
                  explore: bool = True):
        """Act for B lanes: feat (B, N, F), left/right (B, N) int32, mask
        (B, N), amask (B, d), keys (B, 2) uint32. Returns numpy (actions
        (B,) int32, logps (B,) float32, advanced keys (B, 2) uint32).

        The node dimension is trimmed to the workload's bucket first
        (fcnn excepted): trailing padding rows never influence real
        nodes, so this is exact."""
        mask = np.asarray(mask)
        n = self._trim(mask.sum(axis=1))
        lg = self.actor(self._tensor(np.asarray(feat)[:, :n]),
                        self._tensor(np.asarray(left)[:, :n]),
                        self._tensor(np.asarray(right)[:, :n]),
                        self._tensor(mask[:, :n]))
        lg = lg.masked_fill(~(self._tensor(amask) > 0), -1e9)
        logp_all = torch.log_softmax(lg, dim=-1)
        pairs = prng.split(keys)
        if explore:
            a = prng.categorical(pairs[:, 1], lg)
        else:
            a = lg.argmax(dim=-1)
        logp = logp_all.gather(1, a[:, None])[:, 0]
        host = torch.stack([a.to(torch.float32), logp]).cpu().numpy()
        return host[0].astype(np.int32), host[1], pairs[:, 0]

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

    # ------------------------------------------------------------- update
    def ppo_update(self, traj) -> Dict[str, float]:
        """Single-trajectory PPO update: an episode-batch of one."""
        return self.ppo_update_batch([traj])

    def _actor_loss(self, b) -> torch.Tensor:
        clip, eta = self.cfg.clip, self.cfg.entropy
        lg = self.actor(b["feat"], b["left"], b["right"], b["mask"])
        live = b["amask"] > 0
        logp_all = torch.log_softmax(lg.masked_fill(~live, -1e9), dim=-1)
        logp = logp_all.gather(1, b["action"][:, None])[:, 0]
        ratio = torch.exp(logp - b["old_logp"])
        q, valid = b["q"], b["valid"]
        un = ratio * q
        cl = torch.clamp(ratio, 1 - clip, 1 + clip) * q
        n_valid = torch.clamp(valid.sum(), min=1.0)
        l_clip = -torch.sum(torch.minimum(un, cl) * valid) / n_valid
        p = torch.exp(logp_all)
        ent = torch.sum(torch.where(live, p * logp_all, 0.0), -1)
        l_ent = torch.sum(ent * valid) / n_valid
        return l_clip + eta * l_ent

    def _critic_loss(self, s) -> torch.Tensor:
        v = self.critic(s["feat"], s["left"], s["right"], s["mask"])[:, 0]
        err = (v - s["v_target"]) ** 2
        return torch.sum(err * s["valid"]) / torch.clamp(s["valid"].sum(),
                                                         min=1.0)

    @staticmethod
    def _step(net, loss, opt, ocfg) -> torch.Tensor:
        """One backward of `loss` and one AdamW step of `net` in place."""
        named = dict(net.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        adamw_update(nest(named), nest(dict(zip(named, grads))), opt, ocfg)
        return loss.detach()

    def ppo_update_batch(self, trajs) -> Dict[str, float]:
        """One PPO update over an episode-batch of trajectories (Alg. 1
        per lane): v_pi from the realised returns, q from the CURRENT
        critic (one forward over all B*K padded states), then e epochs of
        clipped updates against the frozen old log-probabilities. Returns
        the last epoch's losses."""
        cfg = self.cfg
        trajs = [t for t in trajs if len(t.actions) > 0]
        if not trajs:
            return {"actor_loss": 0.0, "critic_loss": 0.0}
        B = len(trajs)
        K = cfg.max_steps + 1
        F = self.meta.feat_dim

        feat = np.zeros((B, K, MAX_NODES, F), np.float32)
        left = np.zeros((B, K, MAX_NODES), np.int32)
        right = np.zeros((B, K, MAX_NODES), np.int32)
        mask = np.zeros((B, K, MAX_NODES), np.float32)
        svalid = np.zeros((B, K), np.float32)
        v_pi = np.zeros((B, K), np.float32)
        amask = np.zeros((B, K - 1, self.space.d), np.float32)
        action = np.zeros((B, K - 1), np.int64)
        old_logp = np.zeros((B, K - 1), np.float32)
        tvalid = np.zeros((B, K - 1), np.float32)
        ks, n_states_b, rs_b, term_b = [], [], [], []
        for bi, traj in enumerate(trajs):
            k = len(traj.actions)
            n_states = min(len(traj.states), K)
            for i, s in enumerate(traj.states[:K]):
                feat[bi, i], left[bi, i], right[bi, i], mask[bi, i] = s
            svalid[bi, :n_states] = 1.0
            # v_pi(s_i) = sum_{j>i} r_j - sqrt(T_execute)  (Alg. 1 line 2;
            # the paper's +sqrt is a sign typo — R(tau) subtracts it)
            rs = np.asarray(traj.rewards, np.float32)
            term = -np.sqrt(traj.t_execute)
            for i in range(n_states):
                v_pi[bi, i] = rs[i:].sum() + term
            for t in range(k):
                amask[bi, t] = traj.masks[t]
                action[bi, t] = traj.actions[t]
                old_logp[bi, t] = traj.logps[t]
                tvalid[bi, t] = 1.0
            ks.append(k)
            n_states_b.append(n_states)
            rs_b.append(rs)
            term_b.append(term)

        # trim the node dimension to the batch's bucketed max (exact:
        # trailing padding never influences real nodes; fcnn excepted)
        N = self._trim(mask.sum(axis=2))
        feat, left = feat[:, :, :N], left[:, :, :N]
        right, mask = right[:, :, :N], mask[:, :, :N]
        states = {"feat": self._tensor(feat.reshape(B * K, N, F)),
                  "left": self._tensor(left.reshape(B * K, N)),
                  "right": self._tensor(right.reshape(B * K, N)),
                  "mask": self._tensor(mask.reshape(B * K, N))}

        # q_t = r_{t+1} + v_phi(s_{t+1}) - v_phi(s_t) for every ACTION; if
        # the terminal state s_k was not encodable, fall back to its
        # realised value v_pi(s_k) = -sqrt(T)
        with torch.no_grad():
            v_phi = self.critic(**states)[:, 0].cpu().numpy().reshape(B, K)
        q = np.zeros((B, K - 1), np.float32)
        for bi in range(B):
            for t in range(ks[bi]):
                v_next = v_phi[bi, t + 1] if t + 1 < n_states_b[bi] \
                    else term_b[bi]
                q[bi, t] = rs_b[bi][t] + v_next - v_phi[bi, t]

        T = B * (K - 1)
        batch = {k: v.view(B, K, *v.shape[1:])[:, :-1].reshape(
            T, *v.shape[1:]) for k, v in states.items()}
        batch.update({"amask": self._tensor(amask.reshape(T, -1)),
                      "action": self._tensor(action.reshape(T)),
                      "old_logp": self._tensor(old_logp.reshape(T)),
                      "q": self._tensor(q.reshape(T)),
                      "valid": self._tensor(tvalid.reshape(T))})
        sbatch = dict(states, v_target=self._tensor(v_pi.reshape(B * K)),
                      valid=self._tensor(svalid.reshape(B * K)))
        for _ in range(cfg.ppo_epochs):
            al = self._step(self.actor, self._actor_loss(batch), self.aopt,
                            self._acfg)
            cl = self._step(self.critic, self._critic_loss(sbatch),
                            self.copt, self._ccfg)
        losses = torch.stack([al, cl]).cpu().numpy()
        return {"actor_loss": float(losses[0]), "critic_loss": float(losses[1])}

    def param_count(self) -> int:
        return sum(p.numel() for net in (self.actor, self.critic)
                   for p in net.parameters())

    def clone(self, seed: int = 0) -> "AqoraAgent":
        """A fresh agent on the same device (own PRNG chain) carrying a
        deep COPY of this agent's params and optimizer states."""
        from repro_torch.checkpoint import agent_state, install_agent_state
        other = type(self)(self.meta, self.cfg, seed=seed, device=self.device)
        install_agent_state(other, agent_state(self))
        return other
