"""The port's dry run on the CPU: the H100 roofline, the op counter, the
kernel wrappers on `meta`, and `run_cell`.

* `Roofline`'s terms and bottleneck under the H100 constants, and
  `model_flops` equal to the reference's for every assigned cell (exact);
* the counter: a 64x128 @ 128x32 matmul is exactly 2·64·128·32 FLOPs; a
  Python loop of T layers counts T times one layer; a reduced qwen3-8b
  train step (and falcon-mamba-7b's, through the scan) counts the same
  FLOPs, bytes, kernel records and peak live bytes on `meta` as on the
  CPU (exact: the same ops; the kernels record their `kernels.work`
  formulas on both, and on the CPU the plain versions are not counted);
* every kernel wrapper on `meta` returns its kernel's output shapes and
  records its work once;
* `run_cell` on `meta` for reduced qwen3-8b's train, prefill and decode:
  the reference's record keys, `params`, `active_params` and
  `model_flops` equal to the reference's functions, `fits`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jregistry  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.kernels import (flash_attention, mamba_scan,  # noqa: E402
                                 tree_conv, work)
from repro_torch.launch import dryrun, opanalysis, steps  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

SMALL = {"train": ShapeConfig("train_small", 32, 2, "train"),
         "prefill": ShapeConfig("prefill_small", 32, 2, "prefill"),
         "decode": ShapeConfig("decode_small", 32, 2, "decode")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ roofline
def test_roofline_terms_on_the_h100():
    r = rl.Roofline(flops_per_device=989e12, bytes_per_device=2 * 3.35e12,
                    coll_bytes_per_device=0.0, chips=1,
                    model_flops=0.5 * 989e12)
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    assert r.t_compute == 1.0 and r.t_memory == 2.0
    assert r.t_collective == 0.0 and r.t_bound == 2.0
    assert r.bottleneck == "memory"
    assert r.useful_flops_ratio == 0.5 and r.mfu_bound == 0.25
    d = r.to_dict()
    j = jroofline.Roofline(1.0, 1.0, 1.0, 1, 1.0).to_dict()
    assert set(d) == set(j)
    r2 = dataclasses.replace(r, bytes_per_device=0.0,
                             coll_bytes_per_device=900e9)
    assert r2.bottleneck == "collective" and r2.t_bound == 2.0


def test_model_flops_match_reference_for_every_cell():
    for arch, shape, ok, _ in registry.assigned_cells():
        jcfg, tcfg = jregistry.get_config(arch), registry.get_config(arch)
        n = jcfg.active_param_count()
        if not jcfg.tie_embeddings and jcfg.family != "audio":
            n -= jcfg.vocab_size * jcfg.d_model
        assert dryrun._useful_params(tcfg) == n, arch
        assert rl.model_flops(tcfg, SHAPES[shape], n) == \
            jroofline.model_flops(jcfg, JSHAPES[shape], n), (arch, shape)


# ------------------------------------------------------------ the counter
def test_matmul_flops_exact():
    for dev in ("cpu", "meta"):
        a = torch.ones((64, 128), device=dev)
        b = torch.ones((128, 32), device=dev)
        with opanalysis.OpCounter() as c:
            a @ b
        assert c.flops == 2 * 64 * 128 * 32
        assert c.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_loop_of_layers_counts_each_trip(dev):
    w = torch.ones((16, 16), device=dev)

    def run(T):
        h = torch.ones((4, 16), device=dev)
        with opanalysis.OpCounter() as c:
            for _ in range(T):
                h = torch.tanh(h @ w).reshape(4, 16)
        return c
    one, five = run(1), run(5)
    assert (five.flops, five.bytes, five.ops) == \
        (5 * one.flops, 5 * one.bytes, 5 * one.ops)
    assert one.flops == 2 * 4 * 16 * 16 + 4 * 16


def count(cfg, shape, dev):
    ins = list(steps.input_specs(cfg, shape, dev))
    if dev == "cpu":
        ins[0] = lm.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        if shape.kind == "train":
            ins[1] = adamw_init(ins[0], getattr(torch, cfg.opt_moment_dtype))
    counter, mem, _ = dryrun.count_step(cfg, shape, inputs=tuple(ins))
    return counter, mem


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b"])
def test_meta_count_equals_cpu_count(arch):
    cfg = registry.reduced(registry.get_config(arch))
    meta, mmeta = count(cfg, SMALL["train"], "meta")
    cpu, mcpu = count(cfg, SMALL["train"], "cpu")
    assert meta.kernels and meta.kernels == cpu.kernels
    assert (meta.flops, meta.bytes, meta.peak_live_bytes) == \
        (cpu.flops, cpu.bytes, cpu.peak_live_bytes)
    assert mmeta == mcpu
    name = "flash_attention" if arch == "qwen3-8b" else "mamba_scan"
    layers = cfg.n_superblocks * len(cfg.block_pattern)
    # the forward and the remat re-forward, a layer
    assert meta.kernel_totals()[name]["calls"] == 2 * layers


def test_kernel_wrappers_on_meta():
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    with opanalysis.OpCounter() as c:
        out = flash_attention.flash_attention(
            t(8, 16, 64, dtype=torch.bfloat16), t(2, 24, 64,
                                                  dtype=torch.bfloat16),
            t(2, 24, 64, dtype=torch.bfloat16))
        y, h = mamba_scan.mamba_scan(t(2, 8, 32), t(2, 8, 32), t(32, 16),
                                     t(2, 8, 16), t(2, 8, 16), D=t(32))
        feat, mask = t(3, 20, 26), t(3, 20)
        idx = torch.zeros((3, 20), dtype=torch.int32, device="meta")
        params = {l: {"wr": t(26 if l == "conv1" else 96, 96),
                      "wl": t(26 if l == "conv1" else 96, 96),
                      "wrt": t(26 if l == "conv1" else 96, 96), "b": t(96)}
                  for l in tree_conv.LAYERS}
        enc = tree_conv.tree_cnn_fused(feat, idx, idx, mask, params)
        gf, gm, gp = tree_conv.tree_cnn_fused_backward(
            feat, idx, idx, mask, params, t(3, 96))
        conv = tree_conv.tree_conv(feat, idx, idx, mask,
                                   *(params["conv1"][w]
                                     for w in tree_conv.WEIGHTS))
    assert out.shape == (8, 16, 64) and out.dtype == torch.bfloat16
    assert y.shape == (2, 8, 32) and h.shape == (2, 32, 16)
    assert enc.shape == (3, 96) and conv.shape == (3, 20, 96)
    assert gf.shape == feat.shape and gm.shape == mask.shape
    assert gp["conv2"]["wr"].shape == (96, 96)
    assert c.flops == sum(k["flops"] for k in c.kernels)
    assert [k["name"] for k in c.kernels] == [
        "flash_attention", "mamba_scan", "tree_cnn_fused",
        "tree_cnn_fused_bwd", "tree_conv"]
    assert (c.kernels[0]["bytes"], c.kernels[0]["flops"]) == \
        work.attention_work(8, 2, 16, 24, 64, causal=True, window=0,
                            itemsize=2)
    assert flash_attention.launches == 0 and mamba_scan.launches == 0


# ------------------------------------------------------------ run_cell
KEYS = {"arch", "shape", "mesh", "chips", "params", "active_params",
        "memory", "hlo_analysis", "collectives", "roofline", "ok", "fits"}
MEMORY_KEYS = {"temp_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes", "live_bytes_per_device"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_record(kind):
    jcfg = jregistry.reduced(jregistry.get_config("qwen3-8b"))
    cfg = registry.reduced(registry.get_config("qwen3-8b"))
    shape = SMALL[kind]
    rec = dryrun.run_cell("qwen3-8b", shape.name, verbose=False, cfg=cfg,
                          shape=shape)
    assert KEYS <= set(rec) and MEMORY_KEYS <= set(rec["memory"])
    assert rec["chips"] == 1 and rec["mesh"] == "16x16" and rec["fits"]
    assert rec["params"] == jcfg.param_count()
    assert rec["active_params"] == jcfg.active_param_count()
    n = jcfg.active_param_count() - jcfg.vocab_size * jcfg.d_model
    assert rec["roofline"]["model_flops"] == jroofline.model_flops(
        jcfg, shape, n)
    assert rec["roofline"]["t_collective_s"] == 0.0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    mem = rec["memory"]
    assert mem["live_bytes_per_device"] >= mem["argument_size_in_bytes"] > 0
    assert rec["hlo_analysis"]["flops"] > rec["roofline"]["model_flops"] / 2
    assert rec["kernels"]["flash_attention"]["calls"] >= 2
    if kind == "train":      # params and moments updated in place
        assert mem["alias_size_in_bytes"] >= 0.99 * \
            mem["argument_size_in_bytes"]


def test_dry_run_reports_what_does_not_fit():
    """A cut qwen3-8b train cell whose step needs more than 80 GB: fits
    is false (counted on meta, nothing allocated)."""
    cfg = dataclasses.replace(registry.get_config("qwen3-8b"), n_layers=2)
    rec = dryrun.run_cell("qwen3-8b", "train_4k", verbose=False, cfg=cfg,
                          shape=ShapeConfig("train_4k", 4096, 16, "train"))
    assert not rec["fits"]
    assert rec["memory"]["live_bytes_per_device"] > dryrun.CARD_BYTES
    assert np.isfinite(rec["roofline"]["t_bound_s"])
