"""Hand-written CUDA kernels for Hopper (sm_90a), each with a launch
counter:

  tree_conv.tree_cnn_fused  — the whole TreeCNN encoder (three tree-conv
                              layers + residual + masked max-pool), one
                              thread-block cluster per tree, child gathers
                              from shared memory (csrc/tree_cnn_fused.cu)
  tree_conv.tree_conv       — one tree-conv layer, children gathered from
                              shared memory (csrc/tree_conv.cu)
  mamba_scan.mamba_scan     — the Mamba-1 selective scan, sequential in
                              time, each channel's states split over
                              lanes, from a given state h0 and returning
                              the final state h_last if asked
                              (csrc/mamba_scan.cu)
  flash_attention.flash_attention
                            — online-softmax attention with GQA, causal,
                              sliding-window and softcap; bf16 on the
                              tensor cores, fp32 exact
                              (csrc/flash_attention.cu)

`ops` holds the model-layout wrappers (`mha_flash`,
`selective_scan_fused`, `tree_conv_batch`); `ref` every kernel's plain
PyTorch version and the oracles with the reference's signatures.

`build` compiles `csrc/*.cu` with nvcc on first use and loads them with
ctypes. A wrapper runs the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises.
"""
