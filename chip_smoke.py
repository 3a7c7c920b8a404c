#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:

  device   the card, and `nvidia-smi`'s name and power limit;
  build    nvcc builds every kernel from `src/repro_torch/kernels/csrc`;
  kernels  every kernel against its plain PyTorch version on the card, at
           the serving shapes (B=8 and B=5, N in {16, 32, 48, 64}, F=26,
           H=96; the trained step-18 weights and random ones; all-masked
           lanes; out-of-range child indices), with its time, the plain
           version's time and the card's bound for the same work; then the
           encoder's backward kernel against its plain version
           (`ref.tree_cnn_fused_bwd_ref`) at the PPO shapes (24 and 32
           trees, N=48), at B=8 and B=5 over N in {16, 32, 48, 64} on
           step-18 and random weights, and on trees with tied maxima:
           the 12 weight grads, gfeat and gmask each within BWD_ATOL +
           BWD_RTOL * |plain|, every case checked before any fails; the
           same inputs twice give bitwise-equal gradients; its time by
           CUDA events beside its bound and the plain version's, with its
           cluster size, blocks an SM and `cudaOccupancyMaxActiveClusters`;
  serve    the repo's default deployment (JOB-like db at scale 0.25, the
           16-query test split, step-18 weights, 8 async lanes, a 48-query
           open-loop stream at 2 qps) served on the card through the
           kernels and again on the CPU through the plain versions: the
           completions must be identical and every act_batch on the card
           must have launched the encoder kernel once;
  train    the training path at the same deployment: step 18's full
           state (parameters and both AdamW states), `train_agent(...,
           episodes=TRAIN_EPISODES, batch_size=8, seed=0)` lockstep on the
           card and again on the CPU through the plain versions. The
           first episode-batch's actions must be equal, the first
           update's losses within TRAIN_LOSS_RTOL, every leaf finite, and
           every PPO update on the card must have launched the forward
           kernel 1 + 2 * epochs times and called the backward 2 * epochs
           times (4 * epochs launches: per-tree and summing kernel);
           then two serial episodes on the card (`act(explore=True)`), a
           Checkpointer save of the trained state that restores to equal
           leaves; before all that, a fresh `AqoraAgent(meta, seed=0)`
           built on the card and on the CPU must be equal leaf for leaf;
  learn    the lifelong-learning loop at the same deployment from step
           18's full state: the serve's 48-query stream served exploring
           on 8 lanes under `make_online_loop` (a PPO update every 8
           completions on 8 replayed trajectories, a policy-store gate
           every 2 updates on the first 4 test queries, an adaptive
           curriculum), on the card and again on the CPU. Completions,
           learner stats (all but host seconds), gate verdicts and scores
           and curriculum promotions must be identical, the final serving
           state finite and within LEARN_LEAF_ATOL of the CPU's, and each
           update on the card must have launched the forward kernel
           1 + 2 * epochs times and the backward 4 * epochs times. The
           same stream served on the card with a shadow-mode store (no
           curriculum) must be bit-identical to learning off. The line
           gives ms an update and a gate, the learner's host share of the
           serve wall, the walls with learning on, shadow and off, and the
           smallest sampled top-1/top-2 margin;
  qos      a `LatencyPredictor` warm-started from the step-18 critic
           drives `QoSAdmission` (a gold tenant, weight 2, 40 s SLO; a
           bulk tenant rate-limited to 1.5 q/s, 300 s SLO; the standard
           ladder) on 8 EDF lanes over 2 x 24 queries, on the card and on
           the CPU: admissions, deferrals, rejections, degradations, hook
           budgets and completions identical, each prediction within
           QOS_PRED_RTOL of the CPU's (with its smallest relative distance
           from a rung), one forward launch per uncached prediction; then
           `fit_from_replay` (64 samples, batch 16, 2 epochs) on each
           side's learn-phase replay buffer from `default_rng(0)`: the
           same experiences, losses within FIT_LOSS_RTOL, one backward
           call (2 launches) per fit step, the serving critic untouched;
  ops      the `kernels.ops` path at full model widths from the reference's
           configs (src/repro/configs): `mha_flash` at qwen3-8b prefill,
           decode, a 4-query suffix and fp32 and at gemma2-27b's
           sliding-window layer in prefill and decode,
           `selective_scan_fused` at falcon-mamba-7b and at jamba-1.5-large's
           Mamba layer, `tree_conv_batch` at the AQORA encoder's two layer
           shapes on step-18 weights.
           Each call must launch its kernel exactly once and agree with
           the kernel's plain version on the card, |kernel - plain| <=
           atol + rtol * |plain| (ATTENTION_CASES gives the attention
           cases' limits; the scan's are 1e-4, the tree conv's 1e-5);
           every case is checked before any fails. The line gives each
           case's error and the share of its limit it takes, its kernel's
           time, the plain version's, the card's bound, the special-function
           floor of its exps (`sfu_ms`: exps over 16 a clock on each SM at
           the card's top SM clock) and, where one SDPA call computes the
           same function (every qwen3-8b case), that call's time. The scan
           and tree-conv rows add the kernel's own time by torch.profiler
           (`device_ms`); the scan rows also time the whole
           `selective_scan_fused` call (`op_ms`) and count its device
           kernels under torch.profiler, which must be one.

After the ops phase, the `train_profile` line: the backward kernel's
device time by torch.profiler at the PPO shapes, and one PPO update
under torch.profiler (device busy time by kernel, idle share). These
readings come after the ops phase's own, which then are the first in
the process.

With `--profile`, one more card serve runs under `torch.profiler`: its
line gives the device's busy time by kernel and its idle share of the
wall time.

Then the kernels summary line (the encoder rows' launches sum the serve,
learn and qos phases', and the train, learn and qos phases' for the
backward), the `nvidia-smi` line, and the result line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero
(the learn and qos phases check every case first and name each
mismatch); without CUDA the script exits non-zero before printing any
result.
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import (Checkpointer, agent_state,  # noqa: E402
                                    agent_state_from_numpy,
                                    install_agent_state,
                                    load_reference_checkpoint, params_finite,
                                    params_from_numpy)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.agent import (AgentConfig, AqoraAgent,  # noqa: E402
                                    _node_bucket)
from repro_torch.core.encoding import WorkloadMeta, encode_state  # noqa: E402
from repro_torch.core.train_loop import train_agent  # noqa: E402
from repro_torch.kernels import build, ops, ref, tree_conv  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.learn import (AdaptiveCurriculum, PolicyStore,  # noqa: E402
                               make_online_loop)
from repro_torch.serve.driver import (TenantTraffic,  # noqa: E402
                                      multi_tenant_stream, open_loop_stream)
from repro_torch.serve.qos import (DegradationLadder,  # noqa: E402
                                   LatencyPredictor, QoSAdmission,
                                   TenantRegistry, TenantSpec)
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402
from repro_torch.sql.executor import AdaptiveRun  # noqa: E402
from repro_torch.sql.plans import syntactic_plan  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

CKPT = ROOT / "results" / "aqora_ckpt" / "step_00000018"
TOL = 1e-4                 # the reference's own fused-vs-jnp tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 tensor cores, dense
SFU_PER_CLOCK = 16         # exps per clock on each SM (special-function units)
N_LANES = 8
# the backward kernel's weight grads sum over every node and tree in
# another order than the plain version's autograd
BWD_ATOL, BWD_RTOL = 1e-5, 1e-4
TRAIN_EPISODES = 32        # 4 lockstep episode-batches of 8: 4 PPO updates
TRAIN_LOSS_RTOL = 1e-4     # first update's losses, card against CPU
LEARN_QUERIES = 48         # the learn phase's stream: the serve's
LEARN_LOOP = {"update_every": 8, "sample_size": 8, "gate_every": 2,
              "seed": 5}
LEARN_LEAF_ATOL = 1e-4     # final serving state, card against CPU
QOS_QUERIES = 24           # each tenant's stream in the qos phase
QOS_PRED_RTOL = 1e-5       # each admission prediction, card against CPU
FIT_LOSS_RTOL = 1e-4       # fit_from_replay's loss, card against CPU
RUNGS = (1.0, 2.0, 4.0)    # DegradationLadder()'s severity ceilings


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's top SM clock, from nvidia-smi."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def sfu_ms(exps: float) -> float:
    """The least time the card's special-function units take for `exps`
    exps."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (sms * SFU_PER_CLOCK * sm_clock_hz()) * 1e3


def cuda_ms(fn, *, launches: int, reps: int = 5, warmup: int = 10) -> float:
    """Median over `reps` of the mean time of `launches` back-to-back
    calls, by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return float(np.median(times))


# ------------------------------------------------------------------ set-up
def deployment():
    db = datagen.make_job_like(scale=0.25, seed=0)
    wl = workloads.make_workload("job", n_train=100, n_test_per_template=1)
    return db, wl, WorkloadMeta.from_workload(wl)


def make_agent(meta, device, params):
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    agent.load_params(params)
    return agent


def serving_batch(db, wl, meta):
    """The encoder's input at one scheduler tick: the opening states of
    the six test queries with the most relations in lanes 0-5 and two
    all-zero padded lanes, trimmed to the node bucket as act_batch trims
    it (N=48 for this workload)."""
    est = Estimator(db, db.stats)
    F = meta.feat_dim
    feat = np.zeros((N_LANES, 64, F), np.float32)
    left = np.zeros((N_LANES, 64), np.int32)
    right = np.zeros((N_LANES, 64), np.int32)
    mask = np.zeros((N_LANES, 64), np.float32)
    widest = sorted(wl.test, key=lambda q: -len(q.relations))[:6]
    for i, q in enumerate(widest):
        st = AdaptiveRun(db, q, syntactic_plan(q), est,
                         max_hook_steps=3).start()
        feat[i], left[i], right[i], mask[i] = encode_state(st, meta)
    n = _node_bucket(int(mask.sum(axis=1).max()) + 1)
    return feat[:, :n], left[:, :n], right[:, :n], mask[:, :n]


def random_batch(rng, B, N, F):
    """Random trees with all-masked lanes and out-of-range children."""
    feat = rng.standard_normal((B, N, F)).astype(np.float32)
    left = rng.integers(0, N, (B, N)).astype(np.int32)
    right = rng.integers(0, N, (B, N)).astype(np.int32)
    left[:, 1::7] = N + 3                  # past the end -> null child
    right[:, 2::9] = -2                    # negative -> null child
    mask = (rng.random((B, N)) > 0.25).astype(np.float32)
    mask[:, 0] = 0.0                       # the null slot
    mask[-1] = 0.0                         # an all-masked (padded) lane
    return feat, left, right, mask


def random_params(rng, F, H):
    out = {}
    for i, name in enumerate(tree_conv.LAYERS):
        d_in = F if i == 0 else H
        s = (3 * d_in) ** -0.5
        out[name] = {w: rng.standard_normal((d_in, H)).astype(np.float32) * s
                     for w in ("wr", "wl", "wrt")}
        out[name]["b"] = rng.standard_normal(H).astype(np.float32) * 0.1
    return out


def to_cuda(tree):
    if isinstance(tree, dict):
        return {k: to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_cuda(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).cuda()


def kernel_timing(feat, left, right, mask, params, *, launches: int):
    """tree_cnn_fused's time on these inputs (raw launches, no wrapper
    checks) beside the card's bound for the same work: each input byte
    read once, the output written once, and the FMAs of the real nodes."""
    B, N, F = feat.shape
    H = params["conv1"]["wr"].shape[1]
    fn = tree_conv._library()
    ptrs = [t.data_ptr() for t in (feat, left, right, mask)]
    for lname in tree_conv.LAYERS:
        ptrs += [params[lname][w].data_ptr() for w in tree_conv.WEIGHTS]
    out = torch.empty((B, H), device=feat.device)
    args = (*ptrs, out.data_ptr(), B, N, F, H,
            torch.cuda.current_stream().cuda_stream)
    ms = cuda_ms(lambda: fn(*args), launches=launches)
    weight_bytes = sum(t.numel() * 4 for p in params.values()
                       for t in p.values())
    n_bytes = (feat.numel() + left.numel() + right.numel() + mask.numel()
               + B * H) * 4 + weight_bytes
    real_nodes = float(mask.sum())
    flops = 2 * 3 * real_nodes * (F + 2 * H) * H   # the three layers' FMAs
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / FP32_FLOPS * 1e3
    return {"shape": [B, N, F, H], "real_nodes": real_nodes,
            "bytes": n_bytes, "flops": flops, "ms": ms,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations"}


# ------------------------------------------------------------------ phases
def phase_device():
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sm_clock_max_mhz": sm_clock_hz() / 1e6,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    t0 = time.perf_counter()
    log = build.build()
    for name in log:                       # load each, so a bad .so fails here
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "cached": v["cached"],
                          "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
                      for k, v in log.items()}})


def phase_kernels(db, wl, meta, ckpt_tree):
    rng = np.random.default_rng(0)
    F, H = meta.feat_dim, AgentConfig().hidden
    trained = to_cuda(ckpt_tree["actor"]["enc"])
    weights = {"step18": trained, "random": to_cuda(random_params(rng, F, H))}
    cases = []
    for wname, params in weights.items():
        for B in (8, 5):
            for N in (16, 32, 48, 64):
                cases.append((f"{wname}/B{B}/N{N}", params,
                              to_cuda(random_batch(rng, B, N, F))))
    real = to_cuda(serving_batch(db, wl, meta))
    cases.append(("step18/serving", trained, real))

    worst = 0.0
    rows = []
    for name, params, (feat, left, right, mask) in cases:
        out = tree_conv.tree_cnn_fused(feat, left, right, mask, params)
        want = ref.tree_cnn_fused_ref(feat, left, right, mask, params)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        dead = mask.sum(dim=1) == 0
        if not torch.isfinite(out).all() or err > TOL or \
                bool((out[dead] != 0).any()):
            raise AssertionError(f"tree_cnn_fused disagrees on {name}: "
                                 f"max |kernel - plain| = {err}")
        worst = max(worst, err)
        rows.append({"case": name, "shape": list(feat.shape),
                     "max_abs_err": err})

    # time at the serving shape, on a real scheduler tick's input
    timing = kernel_timing(*real, trained, launches=500)
    timing["plain_ms"] = cuda_ms(lambda: ref.tree_cnn_fused_ref(
        *real, trained), launches=100)
    bwd_rows, bwd_worst, bwd_timing = backward_cases(rng, weights, real)
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": worst,
          "cases": rows, "tree_cnn_fused": timing,
          "backward": {"atol": BWD_ATOL, "rtol": BWD_RTOL,
                       "max_abs_err": bwd_worst, "cases": bwd_rows,
                       "bitwise_repeatable": True,
                       "timing": {k: {f: v for f, v in t.items()
                                      if f != "launch"}
                                  for k, t in bwd_timing.items()}}})
    return worst, timing, bwd_worst, bwd_timing


def tied_batch(rng, B, N, F):
    """Random trees in which nodes 1 and 2 are one node twice (the same
    features and children), scaled up so that they hold channel maxima
    together."""
    feat, left, right, mask = random_batch(rng, B, N, F)
    feat[:, 1] *= 10.0
    feat[:, 2] = feat[:, 1]
    left[:, 2], right[:, 2] = left[:, 1], right[:, 1]
    mask[:-1, 1:3] = 1.0
    return feat, left, right, mask


def tied_channels(feat, left, right, mask, params) -> int:
    """(tree, channel) pairs whose max-pool has more than one maximum, by
    the plain version's layers."""
    m = mask.unsqueeze(-1)

    def layer(h, p):
        return ref.tree_layer(h, left, right, m, *(p[w] for w in
                                                   tree_conv.WEIGHTS))
    h1 = layer(feat * m, params["conv1"])
    h2 = layer(h1, params["conv2"])
    h3 = torch.where(m > 0, layer(h2, params["conv3"]) + h2, -torch.inf)
    top = h3.amax(dim=1, keepdim=True)
    return int((((h3 == top) & (m > 0)).sum(dim=1) > 1).sum())


def backward_check(name, params, batch, g):
    """The backward kernel (gfeat and gmask asked for) against its plain
    version on one case: each of the 14 outputs within BWD_ATOL +
    BWD_RTOL * |plain|."""
    gf, gm, gp = tree_conv.tree_cnn_fused_backward(*batch, params, g)
    wf, wm, wp = ref.tree_cnn_fused_bwd_ref(*batch, params, g)
    parts = [closeness("gfeat", gf, wf, BWD_ATOL, BWD_RTOL),
             closeness("gmask", gm, wm, BWD_ATOL, BWD_RTOL)]
    parts += [closeness(f"{l}.{w}", gp[l][w], wp[l][w], BWD_ATOL, BWD_RTOL)
              for l in tree_conv.LAYERS for w in tree_conv.WEIGHTS]
    dead = batch[3].sum(dim=1) == 0
    zero_dead = not (gf[dead].any() or gm[dead].any())
    return {"case": name, "shape": list(batch[0].shape),
            "ok": all(p["ok"] for p in parts) and zero_dead,
            "all_masked_trees_zero": zero_dead,
            "max_abs_err": max(p.get("max_abs_err", float("inf"))
                               for p in parts),
            "limit_share": max(p.get("limit_share", float("inf"))
                               for p in parts),
            "outside": [p["case"] for p in parts if not p["ok"]]}


def backward_cases(rng, weights, real):
    """Every backward case checked, then one error naming each case
    outside its limit; then the same inputs twice, bit for bit; then the
    kernel's time at the actor's and the critic's PPO shapes."""
    F, H = real[0].shape[2], weights["step18"]["conv1"]["wr"].shape[1]
    cases = [(f"step18/ppo-actor/B24/N48", weights["step18"],
              to_cuda(random_batch(rng, 24, 48, F))),
             (f"step18/ppo-critic/B32/N48", weights["step18"],
              to_cuda(random_batch(rng, 32, 48, F))),
             ("step18/serving", weights["step18"], real)]
    for wname, params in weights.items():
        for B in (8, 5):
            for N in (16, 32, 48, 64):
                cases.append((f"{wname}/B{B}/N{N}", params,
                              to_cuda(random_batch(rng, B, N, F))))
        cases.append((f"{wname}/tied/B8/N48", params,
                      to_cuda(tied_batch(rng, 8, 48, F))))
    rows = []
    for name, params, batch in cases:
        g = torch.from_numpy(rng.standard_normal(
            (batch[0].shape[0], H)).astype(np.float32)).cuda()
        row = backward_check(name, params, batch, g)
        if "tied" in name:
            row["tied_channels"] = tied_channels(*batch, params)
        rows.append(row)
    torch.cuda.synchronize()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"tree_cnn_fused backward disagrees: {bad}")
    if any(r["tied_channels"] == 0 for r in rows if "tied" in r["case"]):
        raise AssertionError(f"a tied case has no tied maxima: {rows}")

    name, params, batch = cases[0]
    g = torch.from_numpy(rng.standard_normal(
        (batch[0].shape[0], H)).astype(np.float32)).cuda()
    runs = [tree_conv.tree_cnn_fused_backward(*batch, params, g)
            for _ in range(2)]
    outs = [[r[0], r[1]] + [r[2][l][w] for l in tree_conv.LAYERS
                            for w in tree_conv.WEIGHTS] for r in runs]
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("the backward kernel is not bitwise repeatable")
    timing = {c[0]: backward_timing(*c[2], c[1]) for c in cases[:2]}
    return rows, max(r["max_abs_err"] for r in rows), timing


def backward_timing(feat, left, right, mask, params):
    """The backward kernel's time as the PPO update calls it (weight
    grads only), by CUDA events over raw launches and by torch.profiler
    (its two device kernels, in `phase_late_profiles`), beside the plain
    version's and the card's bound: each input read once, the weight
    grads written once, and the FMAs the real nodes need (the three
    layers' recompute, their weight gradients and the input gradients of
    layers 3 and 2). Beside it, the kernel's blocks a tree, blocks an SM
    and clusters resident at once (`tree_conv.backward_occupancy`)."""
    B, N, Fd = feat.shape
    H = params["conv1"]["wr"].shape[1]
    g = torch.ones((B, H), device=feat.device)
    E = sum(t.numel() for p in params.values() for t in p.values())
    partial = torch.empty((B, E), device=feat.device)
    flat = torch.empty(E, device=feat.device)
    ptrs = [t.data_ptr() for t in (feat, left, right, mask)]
    for lname in tree_conv.LAYERS:
        ptrs += [params[lname][w].data_ptr() for w in tree_conv.WEIGHTS]
    args = (*ptrs, g.data_ptr(), partial.data_ptr(), flat.data_ptr(), 0, 0,
            B, N, Fd, H, torch.cuda.current_stream().cuda_stream)
    fn = tree_conv._bwd_library()
    kernel_ms = cuda_ms(lambda: fn(*args), launches=200)
    occupancy = tree_conv.backward_occupancy(N, Fd, H)
    plain = cuda_ms(lambda: ref.tree_cnn_fused_bwd_ref(
        feat, left, right, mask, params, g), launches=20)
    real_nodes = float(mask.sum())
    flops = 2 * real_nodes * H * (6 * Fd + 18 * H)
    n_bytes = 4 * (feat.numel() + left.numel() + right.numel() + mask.numel()
                   + g.numel() + 2 * E)
    return {"shape": [B, N, Fd, H], "real_nodes": real_nodes, "ms": kernel_ms,
            **{k: occupancy[k] for k in ("cluster", "blocks_per_sm",
                                         "max_active_clusters")},
            "plain_ms": plain, **bound(n_bytes, flops, FP32_FLOPS),
            "launch": lambda: fn(*args)}


def phase_serve(db, wl, meta, params):
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=48, seed=1)
    gpu = make_agent(meta, None, params)      # the default device: CUDA
    cpu = make_agent(meta, "cpu", params)

    call_s, batches = [], []
    inner = gpu.act_batch

    def timed_act_batch(feat, left, right, mask, *a, **k):
        t0 = time.perf_counter()
        out = inner(feat, left, right, mask, *a, **k)
        call_s.append(time.perf_counter() - t0)
        n = min(gpu._nodes, _node_bucket(int(mask.sum(axis=1).max()) + 1))
        batches.append(tuple(np.ascontiguousarray(x[:, :n])
                             for x in (feat, left, right, mask)))
        return out
    gpu.act_batch = timed_act_batch

    margins = []
    record_margins(cpu, margins)

    tree_conv.tree_cnn_fused_launches = 0
    t0 = time.perf_counter()
    comps, stats = QueryService(db, gpu, n_lanes=N_LANES,
                                policy="async").run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tree_conv.tree_cnn_fused_launches

    t0 = time.perf_counter()
    ref_comps, ref_stats = QueryService(db, cpu, n_lanes=N_LANES,
                                        policy="async").run(stream)
    cpu_wall = time.perf_counter() - t0

    if launches != len(call_s) or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {len(call_s)} "
                             "act_batch calls")
    if len(comps) != 48 or len(ref_comps) != 48:
        raise AssertionError(f"{len(comps)}/{len(ref_comps)} completions")
    bad, logp_diff = compare_completions(comps, ref_comps)
    if bad or logp_diff > TOL:
        raise AssertionError(f"card and CPU serves differ: {bad}; logps "
                             f"differ by {logp_diff}")
    # the kernel's time on each act_batch's own input, after the run
    trained = gpu.actor.enc.params()
    per_batch = [kernel_timing(*to_cuda(b), trained, launches=50)
                 for b in batches]
    buckets = {}
    for b in batches:
        buckets[b[0].shape[1]] = buckets.get(b[0].shape[1], 0) + 1
    emit({"phase": "serve", "n_completed": stats.n_completed,
          "n_failed": stats.n_failed, "ticks": stats.ticks,
          "mean_decide_batch": stats.mean_decide_batch,
          "virtual_p50_s": stats.latency_p50,
          "virtual_p99_s": stats.latency_p99, "wall_s": wall,
          "act_batch_calls": len(call_s),
          "act_batch_ms_mean": float(np.mean(call_s)) * 1e3,
          "act_batch_ms_median": float(np.median(call_s)) * 1e3,
          "act_batch_ms_first": call_s[0] * 1e3,
          "kernel_launches": launches, "launches_by_node_bucket": buckets,
          "kernel_ms_mean_over_serve_batches":
              float(np.mean([t["ms"] for t in per_batch])),
          "kernel_bound_ms_mean_over_serve_batches":
              float(np.mean([t["bound_ms"] for t in per_batch])),
          "cpu_wall_s": cpu_wall,
          "identical_to_cpu": True, "max_logp_diff": logp_diff,
          "min_top2_margin": min(margins)})
    return launches


def record_margins(agent, out):
    """Wrap `agent`'s `act_batch` and `act` so that each live decision
    appends the top-1/top-2 margin of the scores it takes its action
    from: the masked logits when greedy, and the Gumbel-perturbed logits
    `prng.categorical` draws from when exploring. Exact action equality
    between the card and the CPU only holds while no margin is a near
    tie."""
    inner_batch, inner_act = agent.act_batch, agent.act

    def note(feat, left, right, mask, amask, keys=None):
        with torch.inference_mode():
            lg = agent.actor(*(agent._tensor(x)
                               for x in (feat, left, right, mask)))
            s = lg.masked_fill(~(agent._tensor(amask) > 0), -1e9).cpu()
        if keys is not None:
            u = prng.gumbel_uniforms(prng.split(keys)[:, 1], s.shape[-1])
            s = -torch.log(-torch.log(torch.from_numpy(u))) + s
        top = s.topk(2, dim=-1).values
        live = torch.from_numpy(np.asarray(mask).sum(axis=1) > 0)
        out.extend((top[:, 0] - top[:, 1])[live].tolist())

    def act_batch(feat, left, right, mask, amask, keys, explore=True):
        note(feat, left, right, mask, amask, keys if explore else None)
        return inner_batch(feat, left, right, mask, amask, keys,
                           explore=explore)

    def act(enc, amask, explore=True):
        if not explore:
            note(*(np.asarray(x)[None] for x in enc), np.asarray(amask)[None])
        return inner_act(enc, amask, explore=explore)

    agent.act_batch, agent.act = act_batch, act


def compare_completions(comps, ref_comps):
    """Every pair of completions whose seq, actions, finish time, lane or
    failure differ (all pairs checked), and the largest logp difference;
    a non-finite logp counts as a difference."""
    bad, logp_diff = [], 0.0
    if len(comps) != len(ref_comps):
        bad.append(f"{len(comps)} vs {len(ref_comps)} completions")
    for a, b in zip(comps, ref_comps):
        if (a.seq, a.traj.actions, a.finish_t, a.lane, a.result.failed) != \
                (b.seq, b.traj.actions, b.finish_t, b.lane, b.result.failed):
            bad.append(f"seq {a.seq}: card {a.traj.actions} {a.finish_t} "
                       f"lane {a.lane} vs cpu {b.traj.actions} {b.finish_t} "
                       f"lane {b.lane}")
        if not np.all(np.isfinite(a.traj.logps)):
            bad.append(f"seq {a.seq}: non-finite logps")
        elif a.traj.logps:
            logp_diff = max(logp_diff, float(np.max(np.abs(
                np.subtract(a.traj.logps, b.traj.logps)))))
    return bad, logp_diff


def leaves_of(agent):
    return {k: v.detach().cpu().numpy() for k, v in
            flatten(agent_state(agent))}


def phase_train(db, wl, meta, ckpt_tree):
    """The training path from step 18's full state, on the card through
    the kernels and on the CPU through the plain versions."""
    # a fresh agent from a seed: drawn on the host, so the card's and the
    # CPU's are equal leaf for leaf
    fresh = [leaves_of(AqoraAgent(meta, AgentConfig(), seed=0, device=dev))
             for dev in (None, "cpu")]
    if set(fresh[0]) != set(fresh[1]) or not all(
            np.array_equal(fresh[0][k], v) for k, v in fresh[1].items()):
        raise AssertionError("a fresh seeded agent differs on the card")
    state = agent_state_from_numpy(ckpt_tree)
    agents = {}
    for dev in (None, "cpu"):                 # None: the default, CUDA
        agent = AqoraAgent(meta, AgentConfig(), seed=0, device=dev)
        install_agent_state(agent, state)
        agents["card" if dev is None else "cpu"] = agent
    gpu, cpu = agents["card"], agents["cpu"]
    epochs = gpu.cfg.ppo_epochs

    updates, act_s, last = [], [], {}
    ppo_inner, act_inner = gpu.ppo_update_batch, gpu.act_batch

    def ppo_update_batch(trajs):
        before = counts()
        b0 = tree_conv.tree_cnn_fused_bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ppo_inner(trajs)
        torch.cuda.synchronize()
        updates.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "forward_launches": counts()["tree_cnn_fused"]
            - before["tree_cnn_fused"],
            "backward_launches": tree_conv.tree_cnn_fused_bwd_launches - b0,
            "actor_states": sum(len(t.actions) for t in trajs),
            "critic_states": sum(min(len(t.states), gpu.cfg.max_steps + 1)
                                 for t in trajs), **m})
        last["trajs"] = trajs
        return m

    def act_batch(*a, **k):
        t0 = time.perf_counter()
        out = act_inner(*a, **k)
        act_s.append(time.perf_counter() - t0)
        return out
    gpu.ppo_update_batch, gpu.act_batch = ppo_update_batch, act_batch

    fa.launches = ms.launches = 0
    tree_conv.tree_conv_launches = tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    t0 = time.perf_counter()
    _, logs = train_agent(db, wl, episodes=TRAIN_EPISODES, batch_size=N_LANES,
                          seed=0, agent=gpu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(counts(),
                    tree_cnn_fused_bwd=tree_conv.tree_cnn_fused_bwd_launches)
    t0 = time.perf_counter()
    _, cpu_logs = train_agent(db, wl, episodes=TRAIN_EPISODES,
                              batch_size=N_LANES, seed=0, agent=cpu)
    cpu_wall = time.perf_counter() - t0

    first = [(l.query, l.actions, l.latency, l.failed) for l in logs[:N_LANES]]
    cpu_first = [(l.query, l.actions, l.latency, l.failed)
                 for l in cpu_logs[:N_LANES]]
    if first != cpu_first:
        raise AssertionError(f"first batch differs: card {first} cpu "
                             f"{cpu_first}")
    loss_rel = {k: abs(getattr(logs[0], k) - getattr(cpu_logs[0], k))
                / max(abs(getattr(cpu_logs[0], k)), 1e-12)
                for k in ("actor_loss", "critic_loss")}
    if max(loss_rel.values()) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"first update's losses differ: {loss_rel}")
    bad = [u for u in updates if u["forward_launches"] != 1 + 2 * epochs
           or u["backward_launches"] != 4 * epochs]
    if bad or not updates:
        raise AssertionError(f"launches per PPO update: {updates}")
    leaves = leaves_of(gpu)
    if not all(np.isfinite(v).all() for v in leaves.values()) or \
            not params_finite(gpu):
        raise AssertionError("a leaf of the trained state is not finite")
    same_actions = sum(a.actions == b.actions for a, b in zip(logs, cpu_logs))

    # two serial episodes on the card: act(explore=True) and ppo_update
    serial = gpu.clone(seed=1)
    f0 = tree_conv.tree_cnn_fused_launches
    _, serial_logs = train_agent(db, wl, episodes=2, batch_size=1, seed=1,
                                 agent=serial)
    serial_launches = tree_conv.tree_cnn_fused_launches - f0
    if not all(np.isfinite(l.actor_loss) for l in serial_logs) or \
            serial_launches == 0 or not params_finite(serial):
        raise AssertionError(f"serial episodes: {serial_logs}")

    # a checkpoint of the card's trained state restores to equal leaves
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    ckpt = Checkpointer(ckpt_dir)
    ckpt.save(TRAIN_EPISODES, agent_state(gpu),
              extra={"episodes": TRAIN_EPISODES})
    restored, step, _ = ckpt.restore(agent_state(gpu))
    back = AqoraAgent(meta, AgentConfig(), seed=0, device=None)
    install_agent_state(back, restored)
    back_leaves = leaves_of(back)
    if step != TRAIN_EPISODES or set(back_leaves) != set(leaves) or not all(
            np.array_equal(back_leaves[k], v) and back_leaves[k].dtype ==
            v.dtype for k, v in leaves.items()):
        raise AssertionError("checkpoint did not restore the trained state")

    emit({"phase": "train", "episodes": TRAIN_EPISODES,
          "batch_size": N_LANES, "ppo_updates": len(updates),
          "ppo_epochs": epochs, "wall_s": wall, "cpu_wall_s": cpu_wall,
          "ppo_update_ms": [u["ms"] for u in updates],
          "ppo_update_ms_mean": float(np.mean([u["ms"] for u in updates])),
          "updates": updates,
          "act_batch_calls": len(act_s),
          "act_batch_ms_mean": float(np.mean(act_s)) * 1e3,
          "act_batch_ms_median": float(np.median(act_s)) * 1e3,
          "launches": launched, "first_batch_equal_to_cpu": True,
          "episodes_with_equal_actions": int(same_actions),
          "first_update_loss_rel_diff": loss_rel,
          "loss_rtol": TRAIN_LOSS_RTOL,
          "card_losses": [(u["actor_loss"], u["critic_loss"])
                          for u in updates],
          "cpu_losses": [(l.actor_loss, l.critic_loss)
                         for l in cpu_logs[::N_LANES]],
          "leaves_finite": True, "serial_episodes": len(serial_logs),
          "serial_forward_launches": serial_launches,
          "checkpoint_restored_equal": True,
          "fresh_seeded_agent_equal_to_cpu": True})
    return launched, gpu.clone(seed=2), last["trajs"]


def learn_serve(db, wl, meta, state, device, *, mode="gate",
                curriculum=True, learning=True, instrument=None):
    """The learn phase's exploring serve from `state` on 8 async lanes,
    with the online loop on (`make_online_loop`: harvester, learner, a
    policy store gating on the first 4 test queries) or off. `instrument`
    sees the serving agent and the learner before the run. Returns
    (completions, learner or None, serving agent, wall seconds)."""
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    hooks, learner = [], None
    if learning:
        store_dir = ROOT / "build" / "chip_smoke_store" / \
            f"{'card' if device is None else device}-{mode}"
        if store_dir.exists():
            shutil.rmtree(store_dir)
        harvester, learner = make_online_loop(
            agent, store=PolicyStore(store_dir, wl.test[:4], mode=mode),
            curriculum=AdaptiveCurriculum(window=8, min_dwell=8)
            if curriculum else None, **LEARN_LOOP)
        hooks = [harvester, learner]
    if instrument is not None:
        instrument(agent, learner)
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=LEARN_QUERIES,
                              seed=1)
    svc = QueryService(db, agent, n_lanes=N_LANES, policy="async",
                       explore=True, hooks=hooks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps, _ = svc.run(stream)
    torch.cuda.synchronize()
    return comps, learner, agent, time.perf_counter() - t0


def gate_rows(store):
    keys = ("step", "accepted", "swapped", "reason", "candidate_score",
            "incumbent_score")
    return [{k: g[k] for k in keys} for g in store.gate_log]


def phase_learn(db, wl, meta, ckpt_tree):
    """The online loop at the default deployment from step 18's full
    state: served exploring on the card and again on the CPU, then on the
    card with a shadow-mode store and no curriculum, and with learning
    off. Every check runs before any fails."""
    state = agent_state_from_numpy(ckpt_tree)
    epochs = AgentConfig().ppo_epochs
    updates, gates = [], []

    def instrument_card(agent, learner):
        inner_update = learner.agent.ppo_update_batch
        inner_gate = learner.store.evaluate_and_maybe_swap

        def ppo_update_batch(trajs):
            f0 = tree_conv.tree_cnn_fused_launches
            b0 = tree_conv.tree_cnn_fused_bwd_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = inner_update(trajs)
            torch.cuda.synchronize()
            updates.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "forward_launches": tree_conv.tree_cnn_fused_launches - f0,
                "backward_launches":
                    tree_conv.tree_cnn_fused_bwd_launches - b0, **m})
            return m

        def evaluate_and_maybe_swap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = inner_gate(*a, **k)
            torch.cuda.synchronize()
            gates.append((time.perf_counter() - t0) * 1e3)
            return rec
        learner.agent.ppo_update_batch = ppo_update_batch
        learner.store.evaluate_and_maybe_swap = evaluate_and_maybe_swap

    margins = []

    def instrument_cpu(agent, learner):
        record_margins(agent, margins)          # exploring serve, probes
        record_margins(learner.agent, margins)  # the candidate's probes

    tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    comps, learner, agent, wall = learn_serve(db, wl, meta, state, None,
                                              instrument=instrument_card)
    launched = {"tree_cnn_fused": tree_conv.tree_cnn_fused_launches,
                "tree_cnn_fused_bwd": tree_conv.tree_cnn_fused_bwd_launches}
    ref_comps, ref_learner, ref_agent, cpu_wall = learn_serve(
        db, wl, meta, state, "cpu", instrument=instrument_cpu)
    shadow, shadow_learner, _, shadow_wall = learn_serve(
        db, wl, meta, state, None, mode="shadow", curriculum=False)
    off, _, _, off_wall = learn_serve(db, wl, meta, state, None,
                                      learning=False)

    bad, logp_diff = compare_completions(comps, ref_comps)
    if logp_diff > TOL:
        bad.append(f"logps differ by {logp_diff}")
    stats, ref_stats = learner.stats.as_dict(), ref_learner.stats.as_dict()
    host_s = stats.pop("host_seconds")
    ref_stats.pop("host_seconds")
    if stats != ref_stats:
        bad.append(f"learner stats: card {stats} cpu {ref_stats}")
    if not stats["updates"] or not stats["gates"]:
        bad.append(f"the learner never updated or gated: {stats}")
    if gate_rows(learner.store) != gate_rows(ref_learner.store):
        bad.append(f"gate verdicts: card {gate_rows(learner.store)} cpu "
                   f"{gate_rows(ref_learner.store)}")
    if learner.curriculum.stats() != ref_learner.curriculum.stats():
        bad.append(f"curriculum: card {learner.curriculum.stats()} cpu "
                   f"{ref_learner.curriculum.stats()}")
    leaves, ref_leaves = leaves_of(agent), leaves_of(ref_agent)
    leaf_diff = max(float(np.abs(v - ref_leaves[k]).max())
                    for k, v in leaves.items())
    if not all(np.isfinite(v).all() for v in leaves.values()) or \
            not leaf_diff <= LEARN_LEAF_ATOL:
        bad.append(f"final serving state: max |card - cpu| {leaf_diff}")
    wrong = [u for u in updates if u["forward_launches"] != 1 + 2 * epochs
             or u["backward_launches"] != 4 * epochs]
    if wrong or len(updates) != stats["updates"]:
        bad.append(f"launches per PPO update: {updates}")
    same = [(c.seq, c.traj.actions, c.traj.logps, c.finish_t, c.lane,
             c.result.failed) for c in shadow] == \
        [(c.seq, c.traj.actions, c.traj.logps, c.finish_t, c.lane,
          c.result.failed) for c in off]
    if not same or shadow_learner.stats.swaps or \
            not shadow_learner.stats.gates:
        bad.append(f"shadow run: identical to learning-off {same}, "
                   f"{shadow_learner.stats.as_dict()}")
    emit({"phase": "learn", "queries": LEARN_QUERIES, **LEARN_LOOP,
          "learner": stats, "curriculum": learner.curriculum.stats(),
          "gate_log": gate_rows(learner.store),
          "update_ms": [u["ms"] for u in updates],
          "update_ms_mean": float(np.mean([u["ms"] for u in updates]))
          if updates else None,
          "gate_ms": gates,
          "gate_ms_mean": float(np.mean(gates)) if gates else None,
          "updates": updates, "learner_host_s": host_s,
          "learner_host_share_of_wall": host_s / wall,
          "learner_host_s_shadow": shadow_learner.stats.host_seconds,
          "wall_s_learning_on": wall, "wall_s_shadow": shadow_wall,
          "wall_s_learning_off": off_wall, "cpu_wall_s": cpu_wall,
          "launches": launched, "harvested": len(learner.replay),
          "max_logp_diff": logp_diff, "min_top2_margin": min(margins),
          "max_leaf_diff": leaf_diff, "leaf_atol": LEARN_LEAF_ATOL,
          "shadow_identical_to_learning_off": same,
          "identical_to_cpu": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"learn phase: {bad}")
    return launched, state, learner.replay, ref_learner.replay


def qos_run(db, wl, meta, state, device):
    """The two-tenant QoS serve: a `LatencyPredictor` warm-started from
    the step-18 critic drives `QoSAdmission` (a weighted gold tenant with
    a 40 s SLO, a rate-limited bulk tenant with 300 s; the standard
    ladder) on 8 EDF lanes."""
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    pred = LatencyPredictor(meta, agent=agent)
    reg = TenantRegistry([
        TenantSpec("gold", weight=2.0, slo=40.0, cache_bytes=8 << 20),
        TenantSpec("bulk", weight=1.0, rate=1.5, burst=2, slo=300.0)])
    adm = QoSAdmission(reg, predictor=pred, ladder=DegradationLadder())
    severities, calls = [], []
    choose, predict = adm.ladder.choose, pred.predict_enc

    def noting_choose(predicted, slack, memo_hit=False):
        severities.append(predicted / slack)
        return choose(predicted, slack, memo_hit=memo_hit)

    def timed_predict(enc):
        f0 = tree_conv.tree_cnn_fused_launches
        t0 = time.perf_counter()
        p = predict(enc)                     # ends in a device->host copy
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": tree_conv.tree_cnn_fused_launches - f0})
        return p
    adm.ladder.choose, pred.predict_enc = noting_choose, timed_predict
    stream = multi_tenant_stream([
        TenantTraffic("gold", wl.test, rate=3.0, n_queries=QOS_QUERIES,
                      seed=31),
        TenantTraffic("bulk", wl.test, rate=3.0, n_queries=QOS_QUERIES,
                      seed=32)])
    svc = QueryService(db, agent, n_lanes=N_LANES, policy="edf",
                       tenants=reg, admission=adm)
    comps, stats = svc.run(stream)
    d = stats.as_dict()
    d.pop("hook_seconds")                    # host wall time
    rows = ([(c.seq, c.tenant, c.admit_t, c.finish_t, c.hook_budget,
              c.degraded, c.lane, c.result.failed, tuple(c.traj.actions))
             for c in comps],
            [(r.seq, r.reject_t, r.reason) for r in svc.scheduler.rejections],
            {k: v for k, v in adm.stats().items() if k != "predictor"}, d)
    return {"agent": agent, "pred": pred, "rows": rows, "calls": calls,
            "severities": severities, "predictions": dict(pred._pred_memo)}


def qos_fit(pred, replay):
    """`fit_from_replay` (64 samples, batch 16, 2 epochs) from
    `default_rng(0)`; each fit step timed to a synchronise, with its
    backward kernel launches."""
    steps, inner = [], pred._fit_step

    def fit_step(batch):
        b0 = tree_conv.tree_cnn_fused_bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "backward_launches":
                          tree_conv.tree_cnn_fused_bwd_launches - b0})
        return loss
    pred._fit_step = fit_step
    sampled = [e.seq for e in replay.sample(min(64, len(replay)),
                                            np.random.default_rng(0))]
    loss = pred.fit_from_replay(replay, np.random.default_rng(0),
                                n_samples=64, batch_size=16, epochs=2)
    return loss, sampled, steps


def phase_qos(db, wl, meta, state, replay, ref_replay):
    """QoS admission driven by the warm-started predictor, on the card
    and on the CPU; then both predictors refit from their learn phase's
    replay buffer. Every check runs before any fails."""
    tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    card = qos_run(db, wl, meta, state, None)
    serve_launches = tree_conv.tree_cnn_fused_launches
    cpu = qos_run(db, wl, meta, state, "cpu")
    bad = []
    for name, got, want in zip(("completions", "rejections", "admission",
                                "stats"), card["rows"], cpu["rows"]):
        if got != want:
            bad.append(f"{name}: card {got} cpu {want}")
    preds, ref_preds = card["predictions"], cpu["predictions"]
    pred_rel = max((abs(p - ref_preds[q]) / max(abs(ref_preds[q]), 1e-12)
                    for q, p in preds.items() if q in ref_preds),
                   default=float("inf"))
    if set(preds) != set(ref_preds) or not preds or \
            not pred_rel <= QOS_PRED_RTOL:
        bad.append(f"predictions: {len(preds)} vs {len(ref_preds)}, max "
                   f"relative difference {pred_rel}")
    if any(c["launches"] != 1 for c in card["calls"]) or \
            len(card["calls"]) != len(preds):
        bad.append(f"forward launches per uncached prediction: "
                   f"{card['calls']}")
    rung_distance = min((abs(s - r) / r for s in card["severities"]
                         for r in RUNGS), default=None)

    critic = {k: v.detach().cpu().clone()
              for k, v in card["agent"].critic.state_dict().items()}
    f0 = tree_conv.tree_cnn_fused_launches
    b0 = tree_conv.tree_cnn_fused_bwd_launches
    loss, sampled, steps = qos_fit(card["pred"], replay)
    fit_launches = {"tree_cnn_fused": tree_conv.tree_cnn_fused_launches - f0,
                    "tree_cnn_fused_bwd":
                        tree_conv.tree_cnn_fused_bwd_launches - b0}
    ref_loss, ref_sampled, ref_steps = qos_fit(cpu["pred"], ref_replay)
    loss_rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-12)
    if sampled != ref_sampled:
        bad.append(f"sampled experiences: card {sampled} cpu {ref_sampled}")
    if not loss_rel <= FIT_LOSS_RTOL or not steps:
        bad.append(f"fit loss: card {loss} cpu {ref_loss}")
    if any(s["backward_launches"] != 2 for s in steps) or \
            len(steps) != len(ref_steps):
        bad.append(f"backward calls per fit step: {steps}")
    after = card["agent"].critic.state_dict()
    if not all(torch.equal(after[k].cpu(), v) for k, v in critic.items()):
        bad.append("a fit wrote the serving critic")
    launched = {"tree_cnn_fused": serve_launches
                + fit_launches["tree_cnn_fused"],
                "tree_cnn_fused_bwd": fit_launches["tree_cnn_fused_bwd"]}
    comps, rejections, admission, _ = card["rows"]
    emit({"phase": "qos", "queries_per_tenant": QOS_QUERIES,
          "completed": len(comps), "rejected": len(rejections),
          "admission": admission,
          "predictions": len(preds),
          "predict_ms": [c["ms"] for c in card["calls"]],
          "predict_ms_mean": float(np.mean([c["ms"] for c in card["calls"]]))
          if card["calls"] else None,
          "max_prediction_rel_diff": pred_rel, "prediction_rtol":
          QOS_PRED_RTOL, "min_rung_distance": rung_distance,
          "fit": {"replay": len(replay), "sampled": len(sampled),
                  "steps": len(steps), "loss": loss, "cpu_loss": ref_loss,
                  "loss_rel_diff": loss_rel, "loss_rtol": FIT_LOSS_RTOL,
                  "step_ms": [s["ms"] for s in steps],
                  "step_ms_mean": float(np.mean([s["ms"] for s in steps]))
                  if steps else None},
          "launches": launched, "identical_to_cpu": not bad,
          "mismatches": bad})
    if bad:
        raise AssertionError(f"qos phase: {bad}")
    return launched


def phase_late_profiles(bwd_timing, agent, trajs):
    """The torch.profiler readings of the training path, taken after the
    ops phase (whose own profiler readings come first in the process):
    the backward kernel's device time at the PPO shapes, and one PPO
    update's device busy time and idle share."""
    bwd = {}
    for case, t in bwd_timing.items():
        calls = 20
        kernels = device_kernels(t["launch"], calls)
        bwd[case] = {"device_ms": sum(ms for _, ms in kernels) / calls,
                     "device_kernels_per_call": len(kernels) / calls,
                     **{k: t[k] for k in ("ms", "bound_ms", "cluster",
                                          "blocks_per_sm",
                                          "max_active_clusters")}}
    emit({"phase": "train_profile", "backward_kernel": bwd,
          "ppo_update": profile_update(agent, trajs)})


def profile_update(agent, trajs):
    """One PPO update under torch.profiler: the device's busy time by
    kernel and its idle share of the update's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    agent.ppo_update_batch(trajs)              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.ppo_update_batch(trajs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    durs = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            durs.setdefault(e.name, []).append(e.time_range.elapsed_us())
    rows = sorted(((k, sum(v) / 1e3, len(v)) for k, v in durs.items()),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_kernels": sum(r[2] for r in rows),
            "by_kernel": [{"name": k[:80], "ms": t, "count": n}
                          for k, t, n in rows[:10]]}


def phase_profile(db, wl, meta, params):
    from torch.profiler import ProfilerActivity, profile
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=48, seed=1)
    agent = make_agent(meta, None, params)
    agent.act_batch(*serving_batch(db, wl, meta),             # warm-up
                    np.ones((N_LANES, agent.space.d), np.float32),
                    np.zeros((N_LANES, 2), np.uint32), explore=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        QueryService(db, agent, n_lanes=N_LANES, policy="async").run(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    durs = {}                                 # device-side events only
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            durs.setdefault(e.name, []).append(e.time_range.elapsed_us())
    rows = sorted(((k, sum(v) / 1e3, len(v), float(np.median(v)))
                   for k, v in durs.items()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "wall_s": wall, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "by_kernel": [{"name": k[:80], "ms": ms, "count": n,
                         "median_us": med} for k, ms, n, med in rows[:12]]})


# -------------------------------------------------------------- ops phase
# (case, B, Sq, Sk, H, K, hd, causal, window, softcap, dtype, atol, rtol,
#  the one SDPA call that computes the same function: "is_causal" (top-left
#  causal, the same when Sq = Sk), "full" (no mask: one right-aligned query
#  sees every key), "mask" (an explicit boolean right-aligned causal
#  attn_mask), or None)
# A case holds |kernel - plain| <= atol + rtol * |plain| everywhere. In
# bf16, rtol covers one rounding of the output (at most 2^-7 |x|) and atol
# the kernel's P rounded to bf16 for the P.V product, which shows in the
# rows with few keys (the first rows of prefill and gemma2); the decode
# cases' rows all see 4093 to 4096 keys. Each atol is at least 1.8 times
# what the sound kernel needs (PERF.md); a kernel that drops one 64-key
# tile, or one split's partial in the decode merge, fails at decode.
ATTENTION_CASES = (
    ("qwen3-8b/prefill", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, 4e-3, 1e-2, "is_causal"),
    ("qwen3-8b/decode", 8, 1, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, 1e-3, 1e-2, "full"),
    ("gemma2-27b/local", 1, 8192, 8192, 32, 16, 128, True, 4096, 50.0,
     torch.bfloat16, 4e-3, 1e-2, None),     # SDPA has no softcap
    ("qwen3-8b/fp32", 1, 1024, 1024, 32, 8, 128, True, 0, 0.0,
     torch.float32, 2e-5, 2e-5, "is_causal"),
    ("gemma2-27b/decode-local", 8, 1, 8192, 32, 16, 128, True, 4096, 50.0,
     torch.bfloat16, 1e-3, 1e-2, None),     # SDPA has no softcap
    ("qwen3-8b/suffix4", 8, 4, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, 1e-3, 1e-2, "mask"),   # chunked decode, verification
)
PLAIN_HEADS = 8            # plain attention in slices of 8 heads (memory)

# (case, S, d_inner, d_state): src/repro/configs' widths, batch 1
SCAN_CASES = (
    ("falcon-mamba-7b", 2048, 2 * 4096, 16),        # d_model 4096, expand 2
    ("jamba-1.5-large/mamba", 2048, 2 * 8192, 16),  # d_model 8192, expand 2
)


def closeness(case, out, want, atol, rtol):
    """How `out` stands to `want`: "ok" if both have one shape, `out` is
    finite and |out - want| <= atol + rtol * |want| everywhere; the largest
    |out - want|, the share of its limit the worst element takes (above 1
    fails) and the least atol this rtol would need."""
    out, want = out.float(), want.float()
    if out.shape != want.shape or not torch.isfinite(out).all():
        return {"case": case, "ok": False, "shape": list(out.shape),
                "want_shape": list(want.shape), "finite": False}
    diff = (out - want).abs()
    share = float((diff / (atol + rtol * want.abs())).max())
    return {"case": case, "ok": share <= 1.0, "atol": atol, "rtol": rtol,
            "max_abs_err": float(diff.max()), "limit_share": share,
            "atol_needed": float((diff - rtol * want.abs()).max())}


def attention_plain(qf, kf, vf, **kw):
    """ref.flash_attention_ref over slices of PLAIN_HEADS query rows (and
    their k/v rows), so that the plain version's score matrices stay a few
    GB (gemma2's 32 heads at S=8192 would take 8.6 GB a matrix)."""
    G = qf.shape[0] // kf.shape[0]
    out = torch.empty_like(qf)
    for a in range(0, qf.shape[0], PLAIN_HEADS):
        b = min(a + PLAIN_HEADS, qf.shape[0])
        out[a:b] = ref.flash_attention_ref(qf[a:b], kf[a // G:b // G],
                                           vf[a // G:b // G], **kw)
    return out


def allowed_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the masks allow in one head."""
    qpos = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def needed_keys(Sq, Sk, causal, window) -> int:
    """Keys of one k/v head that some query row may attend to: the bytes
    of k and v the call must read."""
    off = Sk - Sq
    hi = min(Sk - 1, Sq - 1 + off) if causal else Sk - 1
    lo = max(0, off - window + 1) if window > 0 else 0
    return max(0, hi - lo + 1)


def bound(n_bytes, flops, peak):
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / peak * 1e3
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations"}


def counts():
    return {"flash_attention": fa.launches, "mamba_scan": ms.launches,
            "tree_conv": tree_conv.tree_conv_launches,
            "tree_cnn_fused": tree_conv.tree_cnn_fused_launches}


def ops_call(kernel, fn, *args, **kw):
    """One ops call, which must launch `kernel` once and nothing else."""
    before = counts()
    out = fn(*args, **kw)
    after = counts()
    want = {k: v + (k == kernel) for k, v in before.items()}
    if after != want:
        raise AssertionError(f"{fn.__name__} launched {after} from "
                             f"{before}; wanted one {kernel} launch")
    return out


def ops_inputs(ckpt_tree, db, wl, meta):
    """Every ops case's inputs, made on the card from one seed: model
    layout for attention; for the scan falcon-mamba-7b's widths (d_inner
    = 2 * 4096) and jamba-1.5-large's (d_inner = 2 * 8192), both d_state
    16 with Mamba's A = -(1..16) per channel; the serving tick's trees
    and random trees at N=64 for the tree conv."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    attn = []
    for (case, B, Sq, Sk, H, K, hd, causal, window, cap, dtype, atol, rtol,
         sdpa) in ATTENTION_CASES:
        attn.append({"case": case, "dtype": dtype, "atol": atol,
                     "rtol": rtol, "sdpa": sdpa,
                     "args": (randn(B, Sq, H, hd, dtype=dtype),
                              randn(B, Sk, K, hd, dtype=dtype),
                              randn(B, Sk, K, hd, dtype=dtype)),
                     "kw": dict(causal=causal, window=window, softcap=cap)})
    scans = []
    for case, S, di, N in SCAN_CASES:
        scans.append((case, (
            randn(1, S, di), randn(1, S, di).abs() * 0.1,
            -torch.arange(1, N + 1, device="cuda",
                          dtype=torch.float32).repeat(di, 1),
            randn(1, S, N), randn(1, S, N), randn(di))))
    trained = to_cuda(ckpt_tree["actor"]["enc"])
    trees = (to_cuda(serving_batch(db, wl, meta)),
             to_cuda(random_batch(np.random.default_rng(1), N_LANES, 64,
                                  meta.feat_dim)))
    return attn, scans, trained, trees


def phase_ops(ckpt_tree, db, wl, meta):
    """Drive the kernels.ops path at full widths with every count at 0 and
    read the counts. Then hold every result to its kernel's plain version
    on the same inputs, and fail naming each case outside its limit; then
    time each kernel, its plain version and, where one computes the same
    function, PyTorch's own call."""
    attn, scans, trained, (tree1, tree2) = ops_inputs(ckpt_tree, db, wl,
                                                      meta)
    fa.launches = ms.launches = 0
    tree_conv.tree_conv_launches = tree_conv.tree_cnn_fused_launches = 0
    with torch.inference_mode():
        for a in attn:
            a["out"] = ops_call("flash_attention", ops.mha_flash, *a["args"],
                                **a["kw"])
        scan_outs = [ops_call("mamba_scan", ops.selective_scan_fused, *scan)
                     for _, scan in scans]
        conv1 = ops_call("tree_conv", ops.tree_conv_batch, *tree1,
                         trained["conv1"])
        h1 = ops_call("tree_conv", ops.tree_conv_batch, *tree2,
                      trained["conv1"])
        conv2 = ops_call("tree_conv", ops.tree_conv_batch, h1, *tree2[1:],
                         trained["conv2"])
    torch.cuda.synchronize()
    launched = counts()

    convs = (("aqora/conv1", tree1, trained["conv1"], conv1),
             ("aqora/conv1-N64", tree2, trained["conv1"], h1),
             ("aqora/conv2", (h1, *tree2[1:]), trained["conv2"], conv2))
    with torch.inference_mode():
        held = ([attention_check(a) for a in attn]
                + [scan_check(case, scan, out)
                   for (case, scan), out in zip(scans, scan_outs)]
                + [conv_check(*c) for c in convs])
    bad = [h for h in held if not h["ok"]]
    if bad:
        raise AssertionError(f"kernel and plain version disagree: {bad}")
    with torch.inference_mode():
        rows = ([attention_row(a) for a in attn]
                + [scan_row(case, scan) for case, scan in scans]
                + [conv_row(*c) for c in convs])
    for row, h in zip(rows, held):
        row.update(h)
    lone = [r for r in rows if r.get("device_kernels_per_op", 1) != 1]
    if lone:
        raise AssertionError(f"an ops call ran more than its kernel: {lone}")
    emit({"phase": "ops", "launches": launched, "cases": rows})
    return launched, rows


def flat_attention(a):
    """The case's q, k, v and kernel output in the kernel's own layout,
    (B*H, Sq, hd) and (B*K, Sk, hd)."""
    q, k, v = a["args"]
    B, Sq, H, hd = q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
                  for t in (q, k, v))
    return qf, kf, vf, a["out"].transpose(1, 2).reshape(B * H, Sq, hd)


def attention_check(a):
    qf, kf, vf, out = flat_attention(a)
    return closeness(a["case"], out, attention_plain(qf, kf, vf, **a["kw"]),
                     a["atol"], a["rtol"])


def attention_row(a):
    qf, kf, vf, out = flat_attention(a)
    B, Sq, H, hd = a["args"][0].shape
    dst = torch.empty_like(qf)
    ms_kernel = cuda_ms(lambda: fa._launch(qf, kf, vf, dst, scale=None,
                                           **a["kw"]),
                        launches=5, warmup=3)
    plain = cuda_ms(lambda: attention_plain(qf, kf, vf, **a["kw"]),
                    launches=1, reps=3, warmup=1)
    Sk = kf.shape[1]
    pairs = allowed_pairs(Sq, Sk, a["kw"]["causal"], a["kw"]["window"])
    keys = needed_keys(Sq, Sk, a["kw"]["causal"], a["kw"]["window"])
    n_bytes = (2 * qf.numel() + 2 * kf.shape[0] * keys * hd) \
        * qf.element_size()
    flops = 4 * pairs * hd * B * H
    peak = BF16_FLOPS if a["dtype"] == torch.bfloat16 else FP32_FLOPS
    row = {"case": a["case"], "entry": "mha_flash",
           "kernel": "flash_attention",
           "path": fa.kernel_path(B * H, kf.shape[0], Sq, Sk, hd, qf.dtype),
           "q": list(a["args"][0].shape), "kv": list(a["args"][1].shape),
           **a["kw"], "dtype": str(a["dtype"]),
           "allowed_pairs_per_head": pairs, "ms": ms_kernel,
           "plain_ms": plain, **bound(n_bytes, flops, peak),
           "sfu_ms": sfu_ms(pairs * B * H),
           "tflop_per_s": flops / ms_kernel / 1e9,
           "tb_per_s": n_bytes / ms_kernel / 1e9,
           "library_ms": None, "library_note": "none: SDPA has no softcap"}
    row["kernel_over_bound"] = ms_kernel / row["bound_ms"]
    how = a["sdpa"]
    if how is not None:
        q4, k4, v4 = (t.view(B, -1, t.shape[1], hd) for t in (qf, kf, vf))
        kw = {"is_causal": how == "is_causal"}
        if how == "mask":                     # right-aligned causal
            qpos = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
            kw = {"attn_mask": torch.arange(Sk, device="cuda")[None] <= qpos}

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=True, **kw)
        row["library_ms"] = cuda_ms(sdpa, launches=5, warmup=3)
        row["kernel_over_library"] = ms_kernel / row["library_ms"]
        row["library_max_abs_diff"] = float(
            (sdpa().reshape(B * H, Sq, hd).float() - out.float()).abs().max())
        row["library_note"] = ("F.scaled_dot_product_attention("
                               + ("attn_mask=<right-aligned causal>"
                                  if how == "mask" else
                                  f"is_causal={how == 'is_causal'}")
                               + ", enable_gqa=True)")
    return row


def scan_check(case, scan, out):
    x, dt, A, Bs, Cs, D = scan
    want = ref.mamba_scan_ref(x, dt, A, Bs, Cs)[0] + x * D
    return closeness(case, out, want, 1e-4, 1e-4)


def device_kernels(fn, calls: int = 1):
    """(name, device ms) of each device kernel that `calls` calls of `fn`
    run, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, calls: int = 20) -> float:
    """Median device time of the one kernel `fn` launches, by
    torch.profiler: the kernel alone, without the gaps between launches
    that CUDA events over back-to-back calls include."""
    times = [t for _, t in device_kernels(fn, calls)]
    return float(np.median(times)) if times else None


def scan_row(case, scan):
    """The scan kernel's time as selective_scan_fused launches it (with
    the skip term), the whole op's, and their floors."""
    x, dt, A, Bs, Cs, D = scan
    y = torch.empty_like(x)
    ms_kernel = cuda_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, D),
                        launches=5, warmup=3)
    dev_ms = device_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, D), calls=5)
    op_ms = cuda_ms(lambda: ops.selective_scan_fused(*scan), launches=5,
                    warmup=3)
    kernels = [k for k, _ in device_kernels(
        lambda: ops.selective_scan_fused(*scan))]
    plain = cuda_ms(lambda: ref.mamba_scan_ref(x, dt, A, Bs, Cs), launches=1,
                    reps=3, warmup=1)
    B, S, di = x.shape
    N = A.shape[1]
    # per (b, t, d, n): dt*A, exp, a*h + b (2), dx*B, y += C*h (2); per
    # (b, t, d): dt*x and the skip term's FMA (2)
    flops = 7 * B * S * di * N + 3 * B * S * di
    n_bytes = 4 * (3 * x.numel() + A.numel() + Bs.numel() + Cs.numel()
                   + D.numel())
    return {"case": case, "entry": "selective_scan_fused",
            "kernel": "mamba_scan", "x": list(x.shape), "A": list(A.shape),
            "dtype": "torch.float32", "ms": ms_kernel, "device_ms": dev_ms,
            "op_ms": op_ms,
            "device_kernels_per_op": len(kernels),
            "device_kernel_names": sorted(set(k[:60] for k in kernels)),
            "plain_ms": plain, **bound(n_bytes, flops, FP32_FLOPS),
            "sfu_ms": sfu_ms(B * S * di * N),
            "tb_per_s": n_bytes / ms_kernel / 1e9, "library_ms": None,
            "library_note": "none"}


def conv_check(case, tree, p, out):
    return closeness(case, out, ref.tree_conv_batch_ref(
        *tree, *(p[w] for w in tree_conv.WEIGHTS)), 1e-5, 1e-5)


def conv_row(case, tree, p, out):
    feat, left, right, mask = tree
    weights = tuple(p[w] for w in tree_conv.WEIGHTS)
    B, N, Fd = feat.shape
    H = p["wr"].shape[1]
    # raw launches on prepared arguments: at a few microseconds a call the
    # wrapper's Python would be what the events time
    fn = tree_conv._conv_library()
    dst = torch.empty_like(out)
    args = (*(t.data_ptr() for t in (*tree, *weights, dst)),
            B, N, Fd, H, torch.cuda.current_stream().cuda_stream)
    ms_kernel = cuda_ms(lambda: fn(*args), launches=200)
    dev_ms = device_ms(lambda: fn(*args))
    plain = cuda_ms(lambda: ref.tree_conv_batch_ref(*tree, *weights),
                    launches=20)
    n_bytes = 4 * (feat.numel() + left.numel() + right.numel() +
                   mask.numel() + sum(w.numel() for w in weights) + B * N * H)
    flops = 2 * 3 * float(mask.sum()) * Fd * H      # FMAs of the real nodes
    return {"case": case, "entry": "tree_conv_batch", "kernel": "tree_conv",
            "shape": [B, N, Fd, H], "dtype": "torch.float32",
            "ms": ms_kernel, "device_ms": dev_ms, "plain_ms": plain,
            **bound(n_bytes, flops, FP32_FLOPS), "sfu_ms": 0.0,
            "library_ms": None, "library_note": "none"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one serve on the card")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 as the reference
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    db, wl, meta = deployment()
    tree = load_reference_checkpoint(CKPT)
    worst, timing, bwd_worst, bwd_timing = phase_kernels(db, wl, meta, tree)
    launches = phase_serve(db, wl, meta, params_from_numpy(tree))
    train_launches, trained, trajs = phase_train(db, wl, meta, tree)
    learn_launches, state, replay, ref_replay = phase_learn(db, wl, meta,
                                                            tree)
    qos_launches = phase_qos(db, wl, meta, state, replay, ref_replay)
    if args.profile:
        phase_profile(db, wl, meta, params_from_numpy(tree))
    ops_launches, ops_rows = phase_ops(tree, db, wl, meta)
    phase_late_profiles(bwd_timing, trained, trajs)
    summary = [{
        "name": "tree_cnn_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused.cu",
        "replaces": "src/repro/kernels/tree_conv.py:224",
        "launches": launches + learn_launches["tree_cnn_fused"]
        + qos_launches["tree_cnn_fused"], "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "case": "step18/serving"}, {
        "name": "tree_cnn_fused_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused_bwd.cu",
        "replaces": "src/repro/kernels/tree_conv.py:202",
        "launches": train_launches["tree_cnn_fused_bwd"]
        + learn_launches["tree_cnn_fused_bwd"]
        + qos_launches["tree_cnn_fused_bwd"],
        "max_abs_err": bwd_worst,
        **{k: bwd_timing["step18/ppo-actor/B24/N48"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "case": "step18/ppo-actor/B24/N48"}]
    for name, replaces, case in (
            ("tree_conv", "src/repro/kernels/tree_conv.py:56", "aqora/conv2"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:79",
             "qwen3-8b/prefill"),
            ("mamba_scan", "src/repro/kernels/mamba_scan.py:55",
             "falcon-mamba-7b")):
        mine = [r for r in ops_rows if r["kernel"] == name]
        row = next(r for r in mine if r["case"] == case)
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": ops_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}, "case": case})
    if any(r["launches"] == 0 for r in summary):
        raise AssertionError(f"a kernel of the path never launched: {summary}")
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
