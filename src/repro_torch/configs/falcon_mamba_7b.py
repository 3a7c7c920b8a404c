"""falcon-mamba-7b — attention-free Mamba-1 SSM.

64L d_model=4096 d_ff=0 (the Mamba block carries its own gated channel
mixing) vocab=65024, ssm_state=16. [arXiv:2410.05355]
Sub-quadratic: runs the long_500k cell (O(1) recurrent state per step).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    use_rope=False,
    tie_embeddings=True,
    subquadratic=True,
    block_pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
