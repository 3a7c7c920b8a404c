"""Architecture registry: ``get_config(arch)``, ``reduced(cfg)`` smoke
variants, and the assigned (arch x shape) cell enumeration."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (EncoderConfig, MLAConfig, ModelConfig,
                                MoEConfig, SHAPES, SSMConfig, ShapeConfig,
                                shape_applicable)

_MODULES = {
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_15_large",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family/quirks, toy dims: used by CPU smoke tests. Keeps the
    block pattern (so heterogeneity is exercised) but only 2 superblocks."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2 * len(cfg.block_pattern),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        window=64,
        chunk=64,
        vision_tokens=16 if cfg.vision_tokens else 0,
        max_decoder_len=256,
        scale_emb=(128 ** 0.5) if cfg.name.startswith("gemma") else cfg.scale_emb,
    )
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4
    else:
        kw["n_kv_heads"] = 2
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=128,
                              shared_expert_ff=128 if cfg.moe.shared_expert_ff else 0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_frames=32)
    return dataclasses.replace(cfg, **kw)


def assigned_cells() -> List[Tuple[str, str, bool, str]]:
    """All 40 (arch, shape) cells -> (arch, shape, runs, skip_reason)."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out
