"""The port's language models against the JAX package's, on the CPU, in
the configs' own bf16: all ten architectures' reduced configs, `forward`,
`prefill` (logits and cache) and 8 `decode_step`s on the reference's
seeded weights, within the looser bf16 limits, greedy tokens identical
wherever the reference's top-2 margin allows (tests/torch_lm_cases.py
states the limits).
"""
import pytest

pytest.importorskip("torch")

from repro.configs import registry as jregistry  # noqa: E402
from torch_lm_cases import run_case  # noqa: E402


@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    run_case(arch, "bfloat16")
