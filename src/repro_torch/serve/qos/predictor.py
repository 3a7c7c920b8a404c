"""Admission-time latency predictor: a critic-shaped encoder (TreeCNN by
default, or the LSTM, FCNN or QueryFormer) over the encoded syntactic
plan, in PyTorch (the reference's is `repro/serve/qos/predictor.py`).

Before a query touches a lane, its syntactic plan is encoded exactly like
a pre-execution hook state (no materialized stages, every cardinality
unobserved) and a critic-shaped encoder + head predicts its latency,
which the admission policy compares against the query's deadline.

  * Warm start. The head's output o is read as -sqrt(latency), the
    critic's convention (v(s0) ~= -sqrt(T_execute), Alg. 1's return), so
    `LatencyPredictor(meta, agent=agent)` starts from a deep copy of the
    agent's critic, on the agent's device, and is calibrated from the
    first request. A fit never writes the serving critic.
  * Seeded. Without an agent the net draws the reference's weights:
    `nets.EncoderHead` of kind `net` from `prng.split(prng.prng_key(seed),
    2)`, the reference's splits, through `prng.normal`.
  * Training data is harvested serving traffic: `fit_from_replay` draws
    prioritized samples from `learn.ReplayBuffer` (each
    `Experience.traj.states[0]` IS the encoded pre-exec state; failed
    runs carry the timeout as their latency).

On the card the TreeCNN is the fused CUDA kernel (`nets.TreeCNN`); the
other encoders are plain tensor ops, as in the reference. `predict_enc`
runs one (1, MAX_NODES, F) forward and the head, then makes one
device->host copy. `fit` runs each fixed-shape padded batch
(batch_size, MAX_NODES) with `valid` weights through one
`torch.autograd.grad` (the TreeCNN's backward kernel) and one step of the
hand-written AdamW (`repro_torch.optim`: weight decay 0, clip 5), in
place. `device=None` means CUDA and raises when there is none;
`device="cpu"` is the plain path.

Everything is deterministic: fixed-shape batches, a caller-seeded rng for
sampling, and per-query predictions memoized by (fit generation, query)
-- the syntactic encoding of a query never changes.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import nets, prng
from repro_torch.core.agent import param_tree, resolve_device
from repro_torch.core.encoding import MAX_NODES, WorkloadMeta, encode_state
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sql.executor import RuntimeState
from repro_torch.sql.plans import syntactic_plan
from repro_torch.tree import nest


def encode_query(query, meta: WorkloadMeta):
    """Encode `query`'s syntactic plan exactly like the pre-execution hook
    state (no materialized stages, every cardinality unobserved)."""
    state = RuntimeState(query, syntactic_plan(query), {}, None, 0, 0.0, 0,
                         None)
    return encode_state(state, meta)


class LatencyPredictor:
    """Critic-shaped latency regressor: head output o(s) is trained toward
    -sqrt(latency); `predict` returns max(0, -o)^2 seconds.

    With `agent=`, the net is a deep copy of `agent.critic` on the agent's
    device (its encoder kind and width). Otherwise a seeded net is built
    on `device`: None means CUDA (raising when there is none), "cpu" the
    plain path."""

    def __init__(self, meta: WorkloadMeta, *, agent=None, net: str = "treecnn",
                 hidden: int = 96, head_hidden: int = 96, seed: int = 0,
                 lr: float = 1e-3, device=None):
        self.meta = meta
        if agent is not None:
            net = agent.cfg.net
            self.device = agent.device
            self.model = copy.deepcopy(agent.critic)  # warm start, no alias
        else:
            self.device = resolve_device(device, "LatencyPredictor")
            k = prng.split(prng.prng_key(seed), 2)
            self.model = nets.EncoderHead(meta.feat_dim, hidden, head_hidden,
                                          1, k[0], k[1], net).to(self.device)
        self.net = net
        self.opt = adamw_init(self.params)
        self._cfg = AdamWConfig(lr=lr, weight_decay=0.0, grad_clip=5.0)
        self.n_fit_steps = 0
        self.generation = 0               # bumped per fit(); fences the memo
        self.n_refits = 0                 # drift-triggered refresh count
        self.refit_log: List[Dict] = []   # one record per refit_on_drift
        # keyed by the (frozen, value-hashed) Query itself — names are not
        # unique across tenants, but structurally distinct queries must
        # never share a prediction
        self._enc_memo: Dict[object, tuple] = {}
        self._pred_memo: Dict[object, float] = {}

    @property
    def params(self):
        """The net's parameters as the reference's tree ({"enc", "head"}),
        the tensors themselves."""
        return param_tree(self.model)

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------ predict
    @torch.inference_mode()
    def predict_enc(self, enc) -> float:
        """Predicted latency (virtual seconds) for one encoded state."""
        o = float(self.model(*(self._tensor(np.asarray(x)[None])
                               for x in enc))[0, 0])
        return max(0.0, -o) ** 2

    def predict_query(self, query) -> float:
        """Predicted latency for `query`'s syntactic plan (memoized — the
        encoding is a pure function of the query, and predictions only
        change when `fit` bumps the generation)."""
        hit = self._pred_memo.get(query)
        if hit is not None:
            return hit
        enc = self._enc_memo.get(query)
        if enc is None:
            enc = self._enc_memo[query] = encode_query(query, self.meta)
        p = self.predict_enc(enc)
        self._pred_memo[query] = p
        return p

    # ---------------------------------------------------------------- fit
    def _fit_step(self, batch) -> torch.Tensor:
        """One backward of the valid-weighted squared error and one AdamW
        step of the net in place; returns the batch loss (on the device)."""
        o = self.model(batch["feat"], batch["left"], batch["right"],
                       batch["mask"])[:, 0]
        err = (o - batch["target"]) ** 2
        loss = torch.sum(err * batch["valid"]) / \
            torch.clamp(batch["valid"].sum(), min=1.0)
        named = dict(self.model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        adamw_update(nest(named), nest(dict(zip(named, grads))), self.opt,
                     self._cfg)
        return loss.detach()

    def fit(self, encs: List[tuple], latencies: List[float], *,
            batch_size: int = 16, epochs: int = 1) -> float:
        """Regress o(enc) -> -sqrt(latency) with AdamW steps over
        fixed-shape padded batches. Returns the last batch loss."""
        assert len(encs) == len(latencies) and encs
        F = self.meta.feat_dim
        n = len(encs)
        last = None
        for _ in range(epochs):
            for s in range(0, n, batch_size):
                chunk = list(range(s, min(s + batch_size, n)))
                feat = np.zeros((batch_size, MAX_NODES, F), np.float32)
                left = np.zeros((batch_size, MAX_NODES), np.int32)
                right = np.zeros((batch_size, MAX_NODES), np.int32)
                mask = np.zeros((batch_size, MAX_NODES), np.float32)
                target = np.zeros(batch_size, np.float32)
                valid = np.zeros(batch_size, np.float32)
                for bi, i in enumerate(chunk):
                    feat[bi], left[bi], right[bi], mask[bi] = encs[i]
                    target[bi] = -np.sqrt(max(latencies[i], 0.0))
                    valid[bi] = 1.0
                last = self._fit_step({
                    "feat": self._tensor(feat), "left": self._tensor(left),
                    "right": self._tensor(right), "mask": self._tensor(mask),
                    "target": self._tensor(target),
                    "valid": self._tensor(valid)})
                self.n_fit_steps += 1
        self.generation += 1
        self._pred_memo.clear()
        return 0.0 if last is None else float(last)

    def fit_from_replay(self, replay, rng: np.random.Generator, *,
                        n_samples: int = 64, batch_size: int = 16,
                        epochs: int = 2,
                        current_versions: Optional[Dict] = None) -> float:
        """Train from harvested serving experience (`learn.ReplayBuffer`).
        Uses each trajectory's FIRST state — the pre-exec encoding the
        predictor sees at admission — against the realized latency (the
        timeout for failed runs, matching how the scheduler charges them).
        Prioritized sampling keeps the regression pointed at the fresh,
        high-regret traffic. Deterministic given `rng`."""
        exps = [e for e in replay.sample(min(n_samples, len(replay)), rng,
                                         current_versions)
                if e.traj.states]
        if not exps:
            return 0.0
        return self.fit([e.traj.states[0] for e in exps],
                        [e.latency for e in exps],
                        batch_size=batch_size, epochs=epochs)

    def refit_on_drift(self, replay, rng: np.random.Generator, *,
                       current_versions: Optional[Dict] = None,
                       n_samples: int = 64, batch_size: int = 16,
                       epochs: int = 2, trigger: str = "") -> float:
        """Online refresh: retrain from the LIVE replay buffer when the
        drift detector says predictions have diverged from realized
        latencies. Generation-fenced: `fit` bumps `generation` and clears
        the per-query memo, so every admission decision after the refit
        sees the new model, while decisions already made keep the
        prediction they were made with."""
        gen0 = self.generation
        loss = self.fit_from_replay(replay, rng, n_samples=n_samples,
                                    batch_size=batch_size, epochs=epochs,
                                    current_versions=current_versions)
        if self.generation == gen0:
            # every sampled experience was state-less (e.g. hook-budget-0
            # degradations): nothing trainable, no fit ran, the memo is
            # still valid — skip this refit rather than mis-record it
            return loss
        self.n_refits += 1
        self.refit_log.append({"refit": self.n_refits, "trigger": trigger,
                               "generation": self.generation,
                               "loss": round(float(loss), 4)})
        return loss

    def reset_stats(self) -> None:
        """Drop the per-query memos (counters stay; the generation is NOT
        reset — it fences memos and must only move forward). Call between
        independent serving runs so one run's memoized predictions don't
        leak into the next run's measurements."""
        self._pred_memo.clear()
        self._enc_memo.clear()

    def stats(self) -> Dict[str, float]:
        return {"fit_steps": self.n_fit_steps, "generation": self.generation,
                "refits": self.n_refits,
                "memo_entries": len(self._pred_memo)}
