"""The whole-model cases of tests/test_torch_lm.py (fp32 compute) and
tests/test_torch_lm_bf16.py (the configs' own bf16): the port's language
models against the JAX package's, on the CPU.

For each of the ten architectures' reduced configs, the reference's
seeded parameters (`repro.models.lm.init_params`) are carried across with
`checkpoint.lm_params_from_numpy`, and both packages run the same tokens
(numpy, from a seed): `forward` logits over the whole prompt, `prefill`'s
last logits and its cache, then 8 `decode_step`s fed the same next tokens.
On the CPU the port's attention and scan take their kernels' plain
versions (`kernels.ref`).

Limits, relative to the largest |logit| of the reference's forward:

* compute_dtype="float32": 1e-4 for every logit (measured: below 1e-6);
  the cache within 1e-4 of each leaf's largest |value|.
* the configs' own bf16: XLA's CPU and torch round bf16 at different
  places (XLA keeps fused elementwise chains in fp32), so each layer's
  activations differ by a few bf16 ulps (2^-8 relative). Dense and SSM
  archs: BF16_TOL = 3e-2 (measured: at most 1.4e-2, gemma2). MoE archs:
  BF16_MOE_TOL = 0.25 (measured: 0.12 on jamba), because a token whose
  top experts' router probabilities lie within that rounding of each
  other is routed to another expert, a discrete change of its output.
  Greedy tokens must be identical wherever the reference's top-2 margin
  exceeds twice the limit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro_torch.checkpoint import lm_params_from_numpy
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.tree import flatten

B, S, STEPS = 2, 12, 8
FP32_TOL = 1e-4
BF16_TOL = 3e-2
BF16_MOE_TOL = 0.25


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    """The reference's seeded parameters of the reduced arch (they do not
    depend on compute_dtype), as jax arrays and as numpy arrays."""
    cfg = jregistry.reduced(jregistry.get_config(arch))
    jp = jlm.init_params(jax.random.PRNGKey(0), cfg)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def configs(arch, compute_dtype):
    jcfg = jregistry.reduced(jregistry.get_config(arch))
    tcfg = registry.reduced(registry.get_config(arch))
    if compute_dtype is not None:
        jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype)
        tcfg = dataclasses.replace(tcfg, compute_dtype=compute_dtype)
    return jcfg, tcfg


def inputs(jcfg, tcfg, jp, tp, seed=0):
    """Tokens (B, S + STEPS) and each package's cross-attn memory."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    mem_j = mem_t = None
    if jcfg.family == "vlm":
        m = (0.01 * rng.standard_normal(
            (B, jcfg.vision_tokens, jcfg.d_model))).astype(np.float32)
        mem_j = jnp.asarray(m, jcfg.cdtype)
        mem_t = torch.from_numpy(m).to(tcfg.cdtype)
    if jcfg.encoder is not None:
        f = (0.01 * rng.standard_normal(
            (B, jcfg.encoder.n_frames, jcfg.d_model))).astype(np.float32)
        mem_j = jlm.encode(jp, jnp.asarray(f), jcfg)
        mem_t = lm.encode(tp, torch.from_numpy(f), tcfg)
    return toks, mem_j, mem_t


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def check_tokens(want, got, limit, where):
    """Greedy tokens equal wherever the reference's top-2 margin exceeds
    twice `limit`."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * limit
    same = want.argmax(-1) == got.argmax(-1)
    assert same[sure].all(), f"{where}: greedy token differs"


def run_case(arch, dtype):
    """Forward, prefill (logits and cache) and 8 decode steps of `arch`'s
    reduced config, compute dtype `dtype`, against the reference."""
    jp, tree = reference_params(arch)
    jcfg, tcfg = configs(arch, "float32" if dtype == "float32" else None)
    tp = lm_params_from_numpy(tree, "cpu")
    toks, mem_j, mem_t = inputs(jcfg, tcfg, jp, tp)
    prompt_j, prompt_t = jnp.asarray(toks[:, :S]), \
        torch.from_numpy(toks[:, :S]).long()

    want = as_np(jlm.forward(jp, prompt_j, jcfg, memory=mem_j,
                             remat=False)[0])
    with torch.inference_mode():
        got = as_np(lm.forward(tp, prompt_t, tcfg, memory=mem_t)[0])
    scale = float(np.abs(want).max())
    moe = jcfg.moe is not None
    tol = FP32_TOL if dtype == "float32" else (BF16_MOE_TOL if moe
                                               else BF16_TOL)
    limit = tol * scale
    assert got.shape == want.shape == (B, S, jcfg.vocab_size)
    assert np.abs(got - want).max() <= limit, "forward"
    if dtype != "float32":
        check_tokens(want, got, limit, "forward")

    ml = S + STEPS
    lj, cj = jlm.prefill(jp, prompt_j, jcfg, ml, memory=mem_j)
    with torch.inference_mode():
        lt, ct = lm.prefill(tp, prompt_t, tcfg, ml, memory=mem_t)
    assert np.abs(as_np(lt) - as_np(lj)).max() <= limit, "prefill"
    cache_tol = FP32_TOL if dtype == "float32" else tol
    jleaves = flatten(jax.tree_util.tree_map(np.asarray, cj))
    tleaves = flatten(ct)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        a, b = as_np(a), as_np(b)
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= cache_tol * max(np.abs(a).max(), 1e-6), \
            f"prefill cache {path}"

    dec = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, t, c, jcfg, pos,
                                                       memory=mem_j))
    for s in range(STEPS):
        tok = toks[:, S + s:S + s + 1]
        dj, cj = dec(jp, jnp.asarray(tok), cj, jnp.int32(S + s))
        with torch.inference_mode():
            dt, ct = lm.decode_step(tp, torch.from_numpy(tok).long(), ct,
                                    tcfg, S + s, memory=mem_t)
        dj, dt = as_np(dj), as_np(dt)
        assert np.abs(dt - dj).max() <= limit, f"decode step {s}"
        if dtype != "float32":
            check_tokens(dj, dt, limit, f"decode step {s}")
