"""The language models of `repro.models`, for serving: `lm` (embedding,
superblock stack, head; prefill and decode through a cache), `blocks`
(layers and superblocks), `attention` (GQA variants, cross-attention,
MLA), `mamba` (the selective-SSM mixer), `moe` (MLP and MoE FFNs) and
`common` (norms, RoPE, initializers). Attention goes through the
flash-attention kernel and the Mamba prefill through the scan kernel
(`kernels.ops`)."""
