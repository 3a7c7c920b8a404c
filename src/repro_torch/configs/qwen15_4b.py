"""qwen1.5-4b — dense MHA with QKV bias.

40L d_model=2560 20H (kv=20, i.e. full MHA) d_ff=6912 vocab=151936.
[hf:Qwen/Qwen1.5-0.5B family] head_dim = 2560/20 = 128.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
)
