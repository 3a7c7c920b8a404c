"""jamba-1.5-large-398b — hybrid Mamba + attention (1:7) with MoE top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887] Period-8 Jamba block: attention at index 4, Mamba
elsewhere; MoE replaces the MLP on every other layer (odd indices).
Jamba attention uses no positional embeddings (NoPE). head_dim=128.
Sub-quadratic overall: runs the long_500k cell (9 attn layers' KV + O(1)
Mamba state).
"""
from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig, SSMConfig


def _jamba_pattern():
    pat = []
    for i in range(8):
        mixer = "attn_nope" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        pat.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(pat)


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    use_rope=False,
    subquadratic=True,
    # 398B params: fp32 params + fp32 moments = 18.6 GB/chip > 16 GB HBM on
    # the 256-chip pod; bf16 params + bf16 moments = 9.3 GB/chip (DESIGN §5).
    param_dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    block_pattern=_jamba_pattern(),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
