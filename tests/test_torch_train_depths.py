"""The one-card train shapes of chip_smoke.py's train_lm phase that memory
sets, counted on `meta` (no card): qwen1.5-4b whole and falcon-mamba-7b
at its cut depth on their cells' batches (`TRAIN_LM_CELLS`), and
qwen1.5-4b at the rows and tokens its reference driver feeds a step
(`DRIVER_FULL`: 256 rows of 16 tokens, whatever `global_batch` says).

Each step, as `launch.dryrun.count_train` counts it (fp32 parameters,
gradients, both AdamW moments and the step's transients), must peak
under CARD_GB, the room the card's run keeps under its 80 GB, and at
least the state's 16 B a parameter. Its attention and scan kernel
records (the build's draws aside) must be the launches the card's run
requires of a step: the forward and the remat
re-forward, one call each, and one backward call (two launches on the
card), for each attention layer and each Mamba layer.
"""
import functools
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

CARD_GB = 72.0
ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape(case):
    """(cfg, batch, seq) of a case named in the docstring: "<arch>/cell"
    or "<arch>/driver"."""
    cs = _chip_smoke()
    arch, kind = case.split("/")
    if kind == "cell":
        layers, B, S = next(c[1:4] for c in cs.TRAIN_LM_CELLS
                            if c[0] == arch)
        return cs.train_cfg(arch, layers), B, S
    assert cs.DRIVER_FULL["arch"] == arch and not cs.DRIVER_FULL["smoke"]
    return (registry.get_config(arch), *cs.driver_full_rows())


def test_the_driver_draws_256_rows_of_its_sequence():
    """The reference driver's pipeline quirk that DRIVER_FULL's count
    rests on: 256 rows whatever global_batch says."""
    _, B, S = _shape("qwen1.5-4b/driver")
    assert (B, S) == (256, _chip_smoke().DRIVER_FULL["seq_len"])


@pytest.mark.parametrize("case", ["qwen1.5-4b/cell", "falcon-mamba-7b/cell",
                                  "qwen1.5-4b/driver"])
def test_train_step_fits_one_card_with_its_launches(case):
    cfg, B, S = _shape(case)
    counter = dryrun.count_train(cfg, B, S)
    peak = counter.peak_live_bytes / 1e9
    assert 16 * cfg.param_count() / 1e9 < peak < CARD_GB, (case, peak)
    attn = sum(s.mixer != "mamba" for s in cfg.block_pattern) \
        * cfg.n_superblocks
    mamba = cfg.n_layers - attn
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": 2 * attn,
            "mamba_scan": 2 * mamba, "mamba_scan_bwd": 2 * mamba}
    calls = counter.kernel_totals()
    launches = {name: calls.get(name, {"calls": 0})["calls"]
                * (2 if name.endswith("_bwd") else 1) for name in want}
    assert launches == want, case
    assert cfg.n_layers == {"qwen1.5-4b": 40, "falcon-mamba-7b": 32}[
        case.split("/")[0]]
