"""Model FLOPs of a train step, from a configuration file's sizes.

6 a matmul weight a token (the forward's 2 and the backward's 4) for each
weight of a layer's products and for the head, plus attention's forward,
2 (QK^T and PV) · 2 · hd an allowed (query, key) pair and head, three
times. An MoE layer's experts count at the `top_k` experts a token runs,
its router whole. Recomputation (remat) is not counted: this is the work
the model needs, not the work the program chose to do.

A frozen copy of `chip_smoke.step_flops`'s model count, which counts every
expert; the benchmark's tests hold the two equal on the dense cells and
apart by exactly the idle experts on the MoE cell.
"""
from __future__ import annotations

from perfbench.work.kernels import allowed_pairs


def layer_weights(cfg, spec) -> float:
    """Matmul weights one token runs through in one layer of `spec`."""
    D = cfg["d_model"]
    n = 0.0
    if spec["mixer"] == "mamba":
        di, N, R = cfg["d_inner"], cfg["d_state"], cfg["dt_rank"]
        n += D * 2 * di + di * (R + 2 * N) + R * di + di * D
    else:
        H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        n += D * H * hd + 2 * D * K * hd + H * hd * D
    if spec["ffn"] == "mlp":
        n += 3 * D * cfg["d_ff"]
    elif spec["ffn"] == "moe":
        n += D * cfg["n_experts"] \
            + cfg["top_k"] * 3 * D * cfg["d_ff_expert"]
    return n


def attention_fwd(cfg, B, S) -> float:
    """Attention's forward FLOPs over the stack: causal self-attention."""
    per = len(cfg["layers"])
    blocks = cfg["n_layers"] // per
    pairs = allowed_pairs(S, S, True, 0)
    hd = cfg.get("head_dim", 0)
    return sum(blocks * B * cfg["n_heads"] * 2 * (2 * hd) * pairs
               for spec in cfg["layers"] if spec["mixer"] != "mamba")


def step_flops(cfg, B, S) -> float:
    """The model FLOPs of one train step on B sequences of S tokens."""
    per = len(cfg["layers"])
    blocks = cfg["n_layers"] // per
    T = B * S
    mm = sum(blocks * layer_weights(cfg, spec) for spec in cfg["layers"])
    mm = (mm + cfg["d_model"] * cfg["vocab_size"]) * T
    return 6 * mm + 3 * attention_fwd(cfg, B, S)
