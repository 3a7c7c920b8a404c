"""whisper-tiny — encoder-decoder audio model (conv/mel frontend stubbed).

4 logical decoder layers, d_model=384 6H d_ff=1536 vocab=51865.
[arXiv:2212.04356] Each logical decoder layer = self-attn + cross-attn + MLP,
expressed here as TWO LayerSpec entries (self-attn with no FFN, then
cross-attn with the MLP), so n_layers=8 pattern entries == 4 logical layers.
Encoder: 4 bidirectional layers over 1500 precomputed frame embeddings
(the mel-spectrogram conv frontend is a stub per the assignment:
input_specs() supplies the (B, 1500, 384) frame embeddings directly).
LayerNorm + GELU + learned positional embeddings, no RoPE.
"""
from repro_torch.configs.base import EncoderConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=8,                       # 2 pattern entries x 4 logical layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    use_rope=False,
    learned_pos_emb=True,
    max_decoder_len=32_768,
    tie_embeddings=True,
    block_pattern=(LayerSpec(mixer="attn", ffn="none"),
                   LayerSpec(mixer="cross_attn", ffn="mlp")),
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
)
