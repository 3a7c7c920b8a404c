"""The port's configs and LM server against the JAX package's, on the CPU.

* Every architecture's config, its `reduced(...)` and `SHAPES` are
  field-equal to the reference's, and `param_count` (the port counts a
  meta-device init, the reference a `jax.eval_shape` of its init) and
  `active_param_count` are equal for all ten.
* The port's seeded init: the reference's shapes and dtypes leaf for
  leaf, and the reference's `init_params(PRNGKey(seed))` bit for bit
  (tests/test_torch_lm_init.py holds all ten archs at two seeds).
* The serving copy (`lm.serving_params`) casts exactly the leaves the
  reference casts at use and gives the same logits as the parameters it
  was cast from.
* The serving build (`lm.init_params(..., serving=True)`, what
  `BatchedServer(seed=...)` holds) is the serving copy of the seeded
  parameters bit for bit, leaf for leaf with dtypes, one draw a drawn
  leaf, each cast leaf drawn in the compute dtype; a server built so
  gives the greedy tokens of one built from the parameters.
* `BatchedServer(seed=0)` on nine reduced archs (qwen3-8b,
  falcon-mamba-7b, gemma2-27b, whisper-tiny, llama-3.2-vision-90b,
  llama4-scout, minicpm3-4b, qwen1.5-4b and dbrx-132b: every arch the
  card serves), from its seed alone, gives the reference server's
  greedy tokens and its
  sampled tokens (`greedy=False, seed=1`: the same `jax.random` keys and
  Gumbel noise), with compute_dtype="float32": in the configs' own bf16
  the two frameworks round differently and, with random weights, a
  near-tie between the top two logits flips (reduced qwen3-8b does so at
  a row's 4th token); tests/test_torch_lm_bf16.py holds the bf16 logits
  and tokens wherever the margin allows.
* `BatchedServer` without a device asks for CUDA and raises without it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import threefry  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host, and
    with torch's default threads in each, the seeded init's plain
    `jax.random` (hundreds of small ops a slice) took minutes where it
    takes seconds alone (reduced jamba, an 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_config_matches_reference(arch):
    want, got = jregistry.get_config(arch), registry.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(registry.reduced(got)) == \
        dataclasses.asdict(jregistry.reduced(want))
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    for shape in base.SHAPES.values():
        assert base.shape_applicable(got, shape) == \
            jbase.shape_applicable(want, jbase.SHAPES[shape.name])
    assert got.pdtype == getattr(torch, want.param_dtype)
    assert got.cdtype == getattr(torch, want.compute_dtype)


def test_shapes_and_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert registry.assigned_cells() == jregistry.assigned_cells()


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-1.5-large-398b",
                                  "whisper-tiny", "minicpm3-4b"])
def test_seeded_init_has_the_reference_layout(arch):
    cfg = registry.reduced(registry.get_config(arch))
    jcfg = jregistry.reduced(jregistry.get_config(arch))
    a = lm.init_params(prng.prng_key(3), cfg, device="cpu")
    c = lm.init_params(prng.prng_key(4), cfg, device="cpu")
    ref = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    want = flatten(jax.tree_util.tree_map(lambda s: (tuple(s.shape),
                                                     str(s.dtype)), ref))
    got = [(p, (tuple(t.shape), str(t.dtype).replace("torch.", "")))
           for p, t in flatten(a)]
    assert got == want
    for (path, x), (_, y), (_, z) in zip(flatten(a), flatten(ref),
                                         flatten(c)):
        y = np.asarray(y)                            # compared as words
        w = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        np.testing.assert_array_equal(w.numpy().view(f"u{y.itemsize}"),
                                      y.view(f"u{y.itemsize}"), path)
        if path.endswith(("embed", "mixer/wq", "mixer/mamba_in")):
            assert not torch.equal(x, z), path
            assert abs(float(x.float().std()) - 0.02) < 2e-3, path


def test_serving_copy_casts_what_the_reference_casts():
    cfg = registry.reduced(registry.get_config("jamba-1.5-large-398b"))
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    params = lm.init_params(prng.prng_key(0), cfg, device="cpu")
    serving = lm.serving_params(params, cfg)
    kept = set()
    for (path, p), (_, s) in zip(flatten(params), flatten(serving)):
        leaf = path.rsplit("/", 1)[-1]
        if leaf in lm.SERVING_CAST:
            assert s.dtype == torch.bfloat16 and torch.equal(
                s, p.to(torch.bfloat16)), path
        else:
            assert s is p, path
            kept.add(leaf)
    assert kept == {"scale", "router", "mamba_A_log", "mamba_D"}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 10)))
    with torch.inference_mode():
        assert torch.equal(lm.forward(params, toks, cfg)[0],
                           lm.forward(serving, toks, cfg)[0])


SERVING_BUILD_ARCHS = ["gemma2-27b", "whisper-tiny", "llama-3.2-vision-90b",
                       "llama4-scout-17b-a16e", "jamba-1.5-large-398b"]


def _draws(monkeypatch):
    """The dtype of every threefry normal draw from here on."""
    normal, dtypes = threefry.normal, []

    def record(keys, n, **kw):
        dtypes.append(kw.get("dtype", torch.float32))
        return normal(keys, n, **kw)
    monkeypatch.setattr(threefry, "normal", record)
    return dtypes


@pytest.mark.parametrize("arch", SERVING_BUILD_ARCHS)
def test_serving_build_is_the_serving_copy(arch, monkeypatch):
    """jamba's param_dtype is bf16 already: its two builds draw alike."""
    cfg = registry.reduced(registry.get_config(arch))
    key = prng.prng_key(5)
    draws = _draws(monkeypatch)
    want = lm.serving_params(lm.init_params(key, cfg, device="cpu"), cfg)
    n_drawn = len(draws)
    del draws[:]
    got = lm.init_params(key, cfg, device="cpu", serving=True)
    assert len(draws) == n_drawn
    # fp32 draws only for the leaves the serving copy keeps in fp32
    assert draws.count(torch.float32) == sum(
        path.endswith("router") for path, _ in flatten(got))
    assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
    for (path, g), (_, w) in zip(flatten(got), flatten(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path
    assert any(t.dtype == torch.bfloat16 for _, t in flatten(got))


def test_server_from_its_seed_serves_as_from_the_parameters():
    cfg = registry.reduced(registry.get_config("gemma2-27b"))
    prompts = np.random.default_rng(2).integers(
        2, cfg.vocab_size, (2, 10)).astype(np.int32)
    params = lm.init_params(prng.prng_key(3), cfg, device="cpu")
    seeded = BatchedServer(cfg, max_batch=2, device="cpu", seed=3)
    given = BatchedServer(cfg, max_batch=2, device="cpu", params=params)
    np.testing.assert_array_equal(seeded.generate(prompts, 6)[0],
                                  given.generate(prompts, 6)[0])


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b", "gemma2-27b",
                                  "whisper-tiny", "llama-3.2-vision-90b",
                                  "llama4-scout-17b-a16e", "minicpm3-4b",
                                  "qwen1.5-4b", "dbrx-132b"])
def test_server_gives_the_reference_servers_tokens(arch):
    jcfg = dataclasses.replace(jregistry.reduced(jregistry.get_config(arch)),
                               compute_dtype="float32")
    cfg = dataclasses.replace(registry.reduced(registry.get_config(arch)),
                              compute_dtype="float32")
    ref = jserve.BatchedServer(jcfg, max_batch=4, seed=0)
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (4, 16)).astype(np.int32)
    want, _ = ref.generate(prompts, 12)
    want_sampled, _ = ref.generate(prompts, 12, greedy=False, seed=1)
    server = BatchedServer(cfg, max_batch=4, device="cpu", seed=0)
    got, stats = server.generate(prompts, 12)
    assert got.dtype == np.int32 and got.shape == (4, 12)
    np.testing.assert_array_equal(got, want)
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    sampled, _ = server.generate(prompts, 12, greedy=False, seed=1)
    np.testing.assert_array_equal(sampled, want_sampled)
    assert not np.array_equal(sampled, got)


def test_server_without_device_needs_cuda(monkeypatch):
    cfg = registry.reduced(registry.get_config("falcon-mamba-7b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(cfg)
    assert BatchedServer(cfg, device="cpu").device.type == "cpu"
