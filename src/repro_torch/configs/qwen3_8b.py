"""qwen3-8b — dense GQA with per-head QK-RMSNorm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936. [hf:Qwen/Qwen3-8B]
head_dim=128; qk_norm applies RMSNorm to q and k per head before RoPE.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
)
