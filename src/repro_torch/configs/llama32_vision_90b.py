"""llama-3.2-vision-90b — VLM: decoder with gated cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision scaled] Every 5th layer is a tanh-gated
cross-attention layer over precomputed vision patch embeddings (the vision
tower is a stub per the assignment: input_specs() supplies (B, 1600, D)
patch embeddings). Pattern: 4 self-attn + 1 cross-attn, repeated 20x.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    vision_tokens=1600,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),
                   LayerSpec(mixer="attn", ffn="mlp"),
                   LayerSpec(mixer="attn", ffn="mlp"),
                   LayerSpec(mixer="attn", ffn="mlp"),
                   LayerSpec(mixer="cross_attn", ffn="mlp")),
)
