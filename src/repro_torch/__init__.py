"""PyTorch/CUDA port of the LQRS query re-optimizer (`repro`).

Laid out module for module like `repro`: `sql/` (staged engine), `gen/`
(seed contract and schema grammar), `core/` (encoding, actions, TreeCNN
actor-critic), `kernels/` (hand-written CUDA kernels with their plain
PyTorch versions), `serve/` (async lane scheduler and query service) and
`checkpoint/` (reads the reference's checkpoints). It imports torch and
numpy only; entry points run on CUDA unless the caller passes
`device="cpu"`.
"""
