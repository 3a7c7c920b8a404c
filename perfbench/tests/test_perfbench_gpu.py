"""A run's path on the card at small widths through the program's kernels
(head width 32, N = 16): sound runs come out correct under the tiny cells'
limits (`tiny.LIMITS`), with a device trace; a fault comes
out not correct. Marked `gpu`: they skip where there is no card."""
import time

import pytest

from perfbench.harness import cell
from perfbench.tests import tiny


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda:0"


def _spec(family):
    spec = tiny.spec(family)
    if family != "ssm":
        spec["config"].update(d_model=128, head_dim=32)
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm", "moe"])
def test_tiny_cell_on_the_card(family, cuda):
    out = cell.run(_spec(family), 2 ** 31 + 99, 0.5, True, time.time(),
                   cell.Rank(device=cuda))
    assert out["correct"], out["readings"]
    names = " ".join(n for n, _, _ in out["trace"].kernels)
    assert ("mamba_scan_kernel" if family == "ssm"
            else "flash_") in names
    assert out["trace"].busy_s() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_tiny_fault_on_the_card(family, cuda):
    out = cell.run(_spec(family), 5, 0.2, False, time.time(),
                   cell.Rank(device=cuda), faults=("half_batch",))
    assert not out["correct"], out["readings"]
