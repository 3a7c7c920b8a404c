"""Model / run configuration system.

Every assigned architecture is a ``ModelConfig``; layer heterogeneity
(local/global alternation, cross-attention interleave, mamba:attn ratios,
MoE-every-other-layer) is expressed as a *superblock pattern*: the layer stack
is ``n_superblocks`` repetitions of ``block_pattern`` (a tuple of LayerSpec),
and parameters are stacked on a leading superblock axis, as the reference
(`repro.configs.base`) stacks them for its ``lax.scan``; the port's forward
loops over that axis in Python.

A copy of the reference's dataclasses, with two differences: ``pdtype`` and
``cdtype`` return torch dtypes (the fields keep their string names), and
``param_count`` builds the parameters on the ``meta`` device, where the
reference uses ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 16
    top_k: int = 2
    capacity_factor: float = 1.25
    d_ff_expert: int = 0          # 0 -> use cfg.d_ff
    shared_expert_ff: int = 0     # >0 -> add an always-on shared expert MLP
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside a superblock."""
    mixer: str = "attn"           # attn | attn_local | attn_chunked | attn_nope | cross_attn | mamba
    ffn: str = "mlp"              # mlp | moe | none


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    inputs are precomputed frame/patch embeddings."""
    n_layers: int = 4
    n_frames: int = 1500          # fixed encoder sequence length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 524_288

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0      # 0 -> off (gemma2: 50.0)
    final_logit_softcap: float = 0.0     # 0 -> off (gemma2: 30.0)
    window: int = 4096                   # sliding window for attn_local
    chunk: int = 8192                    # chunk size for attn_chunked (llama4)
    rope_theta: float = 10_000.0
    use_rope: bool = True
    scale_emb: float = 1.0               # embedding multiplier (gemma: sqrt(d), minicpm: 12)
    scale_depth: float = 0.0             # residual scale = scale_depth/sqrt(n_layers) (minicpm; 0 -> 1.0)
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "silu"                    # silu | gelu
    tie_embeddings: bool = False
    learned_pos_emb: bool = False        # whisper decoder
    max_decoder_len: int = 32_768        # learned-pos-emb table size

    # heterogeneity
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision_tokens: int = 0               # >0 -> VLM cross-attn memory length

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"    # bf16 for the largest archs (jamba)

    # classification of sequence-mixing complexity (for long_500k gating)
    subquadratic: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern len {len(self.block_pattern)}")

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        assert self.ssm is not None
        return self.ssm.dt_rank or max(1, -(-self.d_model // 16))

    @property
    def moe_d_ff(self) -> int:
        assert self.moe is not None
        return self.moe.d_ff_expert or self.d_ff

    def memory_len(self) -> int:
        """Cross-attention memory length (vision tokens or encoder frames)."""
        if self.encoder is not None:
            return self.encoder.n_frames
        return self.vision_tokens

    def encoder_cfg(self) -> "ModelConfig":
        """Derived config for the encoder stack of enc-dec models."""
        assert self.encoder is not None
        return dataclasses.replace(
            self, name=self.name + "-enc", n_layers=self.encoder.n_layers,
            block_pattern=(LayerSpec(mixer="attn_bidir", ffn="mlp"),),
            encoder=None, use_rope=False, learned_pos_emb=False)

    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly; used for 6ND):
        the parameters built on the meta device, which holds no data."""
        from repro_torch.models import lm
        from repro_torch.tree import leaves
        params = lm.init_params(None, self, device="meta")
        return sum(x.numel() for x in leaves(params))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        total = self.param_count()
        if self.moe is None:
            return total
        # subtract inactive expert params
        n_moe_layers = self.n_superblocks * sum(1 for s in self.block_pattern if s.ffn == "moe")
        per_expert = 3 * self.d_model * self.moe_d_ff  # gate/up/down
        inactive = n_moe_layers * (self.moe.n_experts - self.moe.top_k) * per_expert
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is assigned to run. Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure/partial full-attention arch (quadratic); see DESIGN.md"
    return True, ""
