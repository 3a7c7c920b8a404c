"""A run's path at tiny widths on the CPU, the program's plain versions
under it: sound runs come out correct under the tiny cells' limits
(`tiny.LIMITS`), and each fault a training cell can have, planted
under the timed path, comes out not correct. The look for a chip is
skipped; everything after it runs as on the card."""
import time

import pytest

from perfbench.harness import cell
from perfbench.tests import tiny

SEEDS = (3, 2 ** 31 + 7)


def _run(family, seed, faults=(), compute="bfloat16", limits=None):
    spec = tiny.spec(family, compute, limits)
    return cell.run(spec, seed, 0.2, False, time.time(),
                    cell.Rank(device="cpu"), faults=faults)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", ["dense", "ssm", "moe"])
def test_sound_run_is_correct(family, seed):
    out = _run(family, seed)
    assert out["correct"], out["readings"]
    assert out["steps"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "double_update"])
@pytest.mark.parametrize("family", ["dense", "ssm", "moe"])
def test_fault_is_not_correct(family, fault):
    out = _run(family, SEEDS[1], faults=(fault,))
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("family", ["dense", "ssm", "moe"])
def test_float32_program_meets_the_reference(family):
    """With float32 products the program's plain path and the reference
    agree to float32's rounding: the reference's layers are the
    program's."""
    limits = {"loss_gap": 1e-6, "grad_norm_gap": 1e-5,
              "leaf_grad_gap": 1e-5, "leaf_change_gap": 1e-4}
    out = _run(family, SEEDS[0], compute="float32", limits=limits)
    assert out["correct"], out["readings"]


@pytest.mark.parametrize("faults,correct", [((), True),
                                            (("no_exchange",), False)])
def test_moe_across_ranks(faults, correct):
    """Two gloo ranks, each its half of the experts: the sound run is
    correct and every rank agrees; with the sum over the ranks left out
    it is not."""
    from repro_torch.launch.mesh import spawn_ranks
    got = spawn_ranks(tiny.rank_run, 2, ("moe", SEEDS[0], faults),
                      backend="gloo", devices=["cpu", "cpu"],
                      timeout_s=600)
    assert [c for c, _ in got] == [correct, correct], got
    if correct:         # without the sum each rank goes on with its own
        assert got[0][1] == got[1][1]
