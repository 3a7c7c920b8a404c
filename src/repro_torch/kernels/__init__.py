"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version and a launch counter:

  tree_conv.tree_cnn_fused — the whole TreeCNN encoder (three tree-conv
                             layers + residual + masked max-pool), one
                             thread-block cluster per tree, child gathers
                             from shared memory (csrc/tree_cnn_fused.cu)

`build` compiles `csrc/*.cu` with nvcc on first use and loads them with
ctypes. A wrapper runs the plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises.
"""
