"""gemma2-27b — dense, local/global alternating attention + logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000. [arXiv:2408.00118]
Pattern: (local sliding-window 4096, global full) repeated 23x.
Gemma quirks: (1+scale) RMSNorm, sandwich (pre+post) norms, embeddings
scaled by sqrt(d_model), attn softcap 50, final softcap 30, gelu MLP,
head_dim=128 (decoupled from d_model/n_heads), tied embeddings.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    window=4096,
    scale_emb=4608 ** 0.5,
    act="gelu",
    tie_embeddings=True,
    block_pattern=(LayerSpec(mixer="attn_local", ffn="mlp"),
                   LayerSpec(mixer="attn", ffn="mlp")),
)
