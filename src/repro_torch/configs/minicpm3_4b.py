"""minicpm3-4b — dense, Multi-head Latent Attention (MLA).

62L d_model=2560 40H d_ff=6400 vocab=73448. [hf:openbmb/MiniCPM3-4B]
MiniCPM-specific scaling: embeddings x12, residual branches x(1.4/sqrt(L)).
MLA dims follow the HF config (q_lora 768, kv_lora 256, nope 64 + rope 32,
v_head 64); the decode cache stores the *latent* (kv_lora + k_rope) only.
"""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    scale_emb=12.0,
    scale_depth=1.4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)
