"""Cells at tiny widths for the CPU tests: each family of the benchmark's
configurations (dense attention, Mamba-1, MoE), with the cells' traffic
generator, optimizer and the same check."""
from __future__ import annotations

import copy

BASE = {"rope": True, "rope_theta": 1e6, "tie_embeddings": False,
        "norm": "rmsnorm", "norm_eps": 1e-6, "act": "silu",
        "param_dtype": "float32", "compute_dtype": "bfloat16",
        "opt_moment_dtype": "float32", "vocab_size": 256, "n_layers": 2,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
        "d_ff": 128, "qkv_bias": False}

CONFIGS = {
    "dense": {**BASE, "name": "tiny-dense", "program_arch": "qwen1.5-4b",
              "qkv_bias": True,
              "layers": [{"mixer": "attn", "ffn": "mlp"}]},
    "ssm": {**BASE, "name": "tiny-ssm", "program_arch": "falcon-mamba-7b",
            "n_heads": 1, "n_kv_heads": 1, "head_dim": 64, "d_ff": 0,
            "rope": False, "tie_embeddings": True, "d_state": 16,
            "d_conv": 4, "expand": 2, "d_inner": 128, "dt_rank": 4,
            "layers": [{"mixer": "mamba", "ffn": "none"}]},
    "moe": {**BASE, "name": "tiny-moe", "program_arch": "dbrx-132b",
            "n_kv_heads": 2, "n_experts": 4, "top_k": 2, "d_ff_expert": 64,
            "capacity_factor": 1.25, "aux_loss": 0.01,
            "router_z_loss": 0.001,
            "layers": [{"mixer": "attn", "ffn": "moe"}]},
}

# the tiny cells' own limits, from their readings on the CPU (seeds 3, 11,
# 2**31 + 7): sound runs read at most 5.6e-5, 2.6e-3, 2.7e-3 and 1.6e-2
# (the dense leaves' change), and on the card 2.9e-3 of grad_norm_gap at
# the Mamba cell; each planted fault reads above one of them: a state left
# unchanged 1 (leaf_change_gap), half the batch 0.43 or more
# (grad_norm_gap), an update applied twice 0.82 or more (leaf_change_gap).
# The benchmark's cells hold their own limits, set at their sizes on the
# card: a tiny width rounds differently.
LIMITS = {"loss_gap": 1e-3, "grad_norm_gap": 2e-2, "leaf_grad_gap": 2e-2,
          "leaf_change_gap": 5e-2}

TRAFFIC = {"generator": "train_tokens", "batch": 2, "seq": 32,
           "mean_doc_len": 16, "zipf_a": 1.3,
           "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                         "weight_decay": 0.1, "grad_clip": 1.0,
                         "total_steps": 100}}


def spec(family, compute="bfloat16", limits=None):
    config = copy.deepcopy(CONFIGS[family])
    config["compute_dtype"] = compute
    return {"name": f"tiny-{family}", "cell": {"chips": 1},
            "config": config, "traffic": copy.deepcopy(TRAFFIC),
            "workload": {"reference_steps": 3,
                         "limits": limits or dict(LIMITS)},
            "end_to_end": [], "per_layer": []}


def rank_run(mesh, family, seed, faults, widths=None):
    """One rank of a tiny cell across gloo ranks on the CPU: its correct
    and its readings. `widths`: sizes put in the tiny configuration."""
    import time
    import torch.distributed as dist
    from perfbench.harness import cell
    rank = cell.Rank(device="cpu", mesh=mesh,
                     flag_group=dist.new_group(backend="gloo"))
    s = spec(family)
    s["config"].update(widths or {})
    out = cell.run(s, seed, 0.2, False, time.time(), rank, faults=faults)
    return out["correct"], {k: v[0] for k, v in out["readings"].items()}
