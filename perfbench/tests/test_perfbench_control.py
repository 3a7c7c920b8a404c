"""The control of the check: the plain reference put in the program's
place, its products one precision below the configuration's bf16 (float8
e4m3 operands). On the CPU at a width a test run holds, it reads well
above the sound program on the same comparison; on the card, at the
cell's own size, the committed limits refuse it (marked `gpu`)."""
import time

import pytest

from perfbench import control
from perfbench.harness import cell
from perfbench.tests import tiny

MID = {"dense": dict(d_model=512, head_dim=64, n_heads=8, n_kv_heads=8,
                     d_ff=1024, vocab_size=4096),
       "ssm": dict(d_model=512, d_inner=1024, head_dim=512, dt_rank=32,
                   vocab_size=4096),
       "moe": dict(d_model=512, head_dim=64, n_heads=8, n_kv_heads=2,
                   d_ff_expert=512, vocab_size=4096)}


@pytest.mark.parametrize("family", ["dense", "ssm", "moe"])
def test_control_reads_above_the_program(family):
    spec = tiny.spec(family)
    spec["config"].update(MID[family])
    spec["traffic"].update(seq=256)
    got = control.variants(spec, 1, cell.Rank(device="cpu"),
                           names=("fp8",))["fp8"]
    sound = cell.run(spec, 1, 0.1, False, time.time(),
                     cell.Rank(device="cpu"))["readings"]
    assert got["loss_gap"] >= 3 * sound["loss_gap"][0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen1.5-4b.train.2x4096",
                                  "falcon-mamba-7b.28of64.train.4x2048"])
def test_control_is_refused_at_the_cells_size(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from perfbench.harness import compare
    spec = cell.load(name)
    got = control.variants(spec, 2 ** 31 + 5, cell.Rank(device="cuda:0"),
                           names=("fp8",))["fp8"]
    read = {n: (got[n], "") for n in compare.NAMES}
    assert not compare.verdict(read, spec["workload"]["limits"]), got
