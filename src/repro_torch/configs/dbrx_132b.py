"""dbrx-132b — fine-grained MoE, 16 experts top-4 in every layer.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
[hf:databricks/dbrx-base] head_dim=128.
"""
from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)
