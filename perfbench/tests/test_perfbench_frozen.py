"""The benchmark's frozen copies agree with the program's originals today,
at the cells' shapes: the kernels' work, the model FLOPs (MoE at its
active experts) and the `train_tokens` draw. Each configuration file
holds its source's published values but for what it cuts, and the program
runs what the file states."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

from perfbench.harness import cell
from perfbench.work import flops, kernels

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _spec(name):
    spec = cell.load(name)
    return spec["config"], spec["traffic"], spec["workload"]


@pytest.mark.parametrize("name", CELLS)
def test_kernel_work_matches_the_program(name):
    from repro_torch.kernels import work
    config, traffic, _ = _spec(name)
    B, S = traffic["batch"], traffic["seq"]
    if config["layers"][0]["mixer"] == "mamba":
        di, N = config["d_inner"], config["d_state"]
        assert kernels.scan_work(B, S, di, N) == work.scan_work(B, S, di, N)
        assert kernels.scan_bwd_work(B, S, di, N) \
            == work.scan_bwd_work(B, S, di, N)
        return
    args = (B * config["n_heads"], B * config["n_kv_heads"], S, S,
            config["head_dim"])
    kw = dict(causal=True, window=0, itemsize=2)
    assert kernels.attention_work(*args, **kw) \
        == work.attention_work(*args, **kw)
    assert kernels.attention_bwd_work(*args, **kw) \
        == work.attention_bwd_work(*args, **kw)
    b = work.bound(*work.attention_work(*args, **kw), work.BF16_FLOPS)
    assert kernels.bound_s(*kernels.attention_work(*args, **kw),
                           kernels.BF16_FLOPS) == pytest.approx(
        b["bound_ms"] / 1e3, rel=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_model_flops_match_chip_smoke(name):
    import chip_smoke
    config, traffic, _ = _spec(name)
    B, S = traffic["batch"], traffic["seq"]
    cfg = cell.program_config(config)
    theirs = chip_smoke.step_flops(cfg, B, S)[0]
    ours = flops.step_flops(config, B, S)
    if cfg.moe is None:
        assert ours == pytest.approx(theirs, rel=1e-12)
    else:
        # chip_smoke counts every expert; only top_k run a token
        idle = (6 * B * S * cfg.n_layers * (cfg.moe.n_experts - cfg.moe.top_k)
                * 3 * cfg.d_model * cfg.moe_d_ff)
        assert ours == pytest.approx(theirs - idle, rel=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_train_tokens_match_the_pipeline(name):
    from repro_torch.data import SyntheticLMPipeline
    config, traffic, _ = _spec(name)
    gen = cell.load_module(ROOT / "perfbench" / "generators" /
                           f"{traffic['generator']}.py")
    B, S, V = traffic["batch"], traffic["seq"], config["vocab_size"]
    seed = 2 ** 31 + 12345
    pipe = SyntheticLMPipeline(vocab_size=V, seq_len=S, global_batch=B,
                               seed=seed, n_logical_shards=B,
                               shard_range=(0, B))
    for step in (0, 1, 7):
        ours, theirs = gen.batch(traffic, V, seed, step), pipe.batch_at(step)
        np.testing.assert_array_equal(ours["tokens"], theirs["tokens"])
        np.testing.assert_array_equal(ours["loss_mask"], theirs["loss_mask"])
    rows = gen.batch(traffic, V, seed, 0)["tokens"]
    assert len({r.tobytes() for r in rows}) == B


CONFIG_FILES = sorted((ROOT / "perfbench" / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_config_files_are_the_programs_configs(path):
    """The program runs what each file states: every field the file sets
    reaches the program's configuration as the file gives it."""
    config = json.loads(path.read_text())
    ours = cell.program_config(config)
    for k in cell.CONFIG_FIELDS:
        assert getattr(ours, k) == config[k], k
    assert ours.use_rope == config["rope"]
    assert [dataclasses.asdict(s) for s in ours.block_pattern] \
        == config["layers"]
    for group, fields in ((ours.ssm, cell.SSM_FIELDS),
                          (ours.moe, cell.MOE_FIELDS)):
        for k in fields if group is not None else ():
            assert getattr(group, k) == config[k], k
    assert ours.hd == config["head_dim"]


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_config_files_hold_their_published_values(path):
    """Each file states its source's published values, under the file's
    own names, and differs from them only in the keys it lists as
    reduced, each of them cut down."""
    config = json.loads(path.read_text())
    published, reduced = config["published"], config["reduced"]
    assert set(config["source_names"]) == set(published)
    assert set(reduced) <= set(published)
    for k, v in published.items():
        if k in reduced:
            assert 0 < config[k] < v, k
        else:
            assert config[k] == v, k


def test_benchmark_lists_every_file():
    """Each configuration, traffic mix, workload and per-layer metric that
    BENCHMARK.json names has its file, found by the name."""
    base = ROOT / "perfbench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (base / "traffic" / f"{w['traffic']}.json").is_file()
        assert (base / "workloads" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert callable(cell.load_module(
            base / "metrics" / f"{m['name']}.py").read)
    assert all(m["moves"] == "train_tokens_per_s" for m in BENCH["per_layer"])
