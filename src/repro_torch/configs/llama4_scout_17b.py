"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert,
chunked-local attention with NoPE global layers.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E] Pattern: 3 chunked-local (8192-token
chunks, RoPE) + 1 global NoPE layer; every FFN is MoE(16, top-1) plus an
always-on shared expert of the same width. "Early fusion" multimodality is
out of scope for the LM backbone (text tokens only), per the assignment.
"""
from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    chunk=8192,
    block_pattern=(LayerSpec(mixer="attn_chunked", ffn="moe"),
                   LayerSpec(mixer="attn_chunked", ffn="moe"),
                   LayerSpec(mixer="attn_chunked", ffn="moe"),
                   LayerSpec(mixer="attn_nope", ffn="moe")),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  shared_expert_ff=8192),
)
