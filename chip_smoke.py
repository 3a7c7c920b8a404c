#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:

  device   the card, and `nvidia-smi`'s name and power limit;
  build    nvcc builds every kernel from `src/repro_torch/kernels/csrc`;
  kernels  every kernel against its plain PyTorch version on the card, at
           the serving shapes (B=8 and B=5, N in {16, 32, 48, 64}, F=26,
           H=96; the trained step-18 weights and random ones; all-masked
           lanes; out-of-range child indices; and a DQN train step's
           batch, B=64, N=64, F=19), with its time, the plain version's
           time and the card's bound for the same work at the serving and
           the DQN shape; then the encoder's backward kernel against its
           plain version (`ref.tree_cnn_fused_bwd_ref`) at the PPO shapes
           (24 and 32 trees, N=48), at B=8 and B=5 over N in {16, 32, 48,
           64} on step-18 and random weights, on trees with tied maxima
           and at the DQN shape:
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
  control  the serving cell under every control plane, on the card and
           on the CPU: JOB-like db at scale 0.25 with a young movie_info
           (90% deleted, then ANALYZEd), the serve's 48-query stream with
           one growth delta of 24x movie_info's young rows after query 24;
           step 18's full state on 8 async lanes; bench_faults' `full`
           recovery arm (seeded chaos, retries, hedges against a
           `LatencyPredictor` warm-started from the step-18 critic, a
           breaker over the run's policy store); a tracer and an SLO
           watchdog (alerts unwired); the drift controller (threshold
           re-ANALYZE at CONTROL_REFRESH, refits of the predictor from a
           harvester's replay); plan memory and its superoptimizer on the
           watchdog's plan ledger. Completions, recovery, drift,
           plan-memory and superoptimizer stats, promotions, incidents,
           breaker trips and the trace export must be identical (the
           trace's fields from a card float, TRACE_FLOAT_KEYS, within
           CONTROL_PRED_RTOL; its host-clock fields: none; the stats'
           host-clock fields are left out), predictions within
           CONTROL_PRED_RTOL, refit losses within REFIT_LOSS_RTOL; one
           encoder launch per act_batch and per uncached prediction, none
           for a memoized hit, one forward and 2 backward launches per
           refit fit step. The card's run without the tracer and the
           watchdog must give the same completions bit for bit; the
           breaker's rollback on the card restores every committed tensor
           bit for bit; `serve.obs.export` and `serve.obs.report`'s
           selftests pass on the card under build/. The line gives the
           walls, the tracer's host cost, ms per prediction and refit,
           the superoptimizer's host seconds and each compared float's
           smallest relative distance from its threshold;
  gen      bench_generalize's serving world (`sample_world(202,
           family="person", scale=0.07, ...)`, 72 queries) served by a
           fresh seeded agent on 4 lanes under the world's fault injector
           and a retry ladder, greedy and then exploring (each on a
           freshly sampled world), on the card and on the CPU: completions
           and table versions identical, log-probabilities within TOL,
           one encoder launch per act_batch;
  ablate   the paper's comparison surface at the ablation experiment's
           deployment (`experiments/ablations.py`: the ExtJOB-like db at
           scale 0.4, `make_workload("extjob", n_train=120,
           n_test_per_template=2, seed=7)`: F=19, 10 tables, the trimmed
           node bucket 32, 64 for the FCNN; hidden 96): (a) a fresh
           `AqoraAgent` of each of the LSTM, FCNN and QueryFormer encoders
           on the card and on the CPU, equal leaf for leaf;
           `train_agent(episodes=ABLATE_EPISODES, batch_size=8, seed=0)`
           on each (first batch equal, first losses within
           TRAIN_LOSS_RTOL, every leaf finite); the CPU's trained state on
           the card and greedy `evaluate` of the 24 test queries on each
           (actions, latencies, failures identical; the smallest top-2
           margin printed); ms an act_batch and a PPO update; (b) the
           `DQNAgent` through `train_agent(agent=dqn,
           episodes=DQN_EPISODES)`, serial, on each: the episodes before
           the first train step identical, that step's loss within
           DQN_LOSS_RTOL, one forward launch a greedy act, two forward
           launches and one backward call a train step (B=64, N=64), the
           smallest Q margin; (c) `main_experiment.run_bench("extjob",
           episodes=ABLATE_EPISODES, batch_size=8)` on each, results under
           build/: Spark, Lero and AutoSteer rows identical but for their
           wall-clock fields, AQORA's first episode-batch identical, the
           smallest Lero and AutoSteer score margins and both walls.
           Episode counts are cut (the experiments train 300-400
           episodes); widths are not. Every case is checked first;
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
device time by torch.profiler at the PPO and DQN shapes, and one PPO
update under torch.profiler (device busy time by kernel, idle share);
then the `ablate_profile` line: each ablation encoder's device kernels
and device ms for one greedy act_batch of its first training batch.
These readings come after the ops phase's own, which then are the first
in the process.

With `--profile`, one more card serve runs under `torch.profiler`: its
line gives the device's busy time by kernel and its idle share of the
wall time.

Then the kernels summary line (the encoder rows' launches sum the serve,
learn, qos, control, gen and ablate phases', and the train, learn, qos,
control and ablate phases' for the backward), the `nvidia-smi` line, and
the result line `{"ok": true, "device": {...}}`. Any failure raises and
exits non-zero (the learn, qos, control, gen and ablate phases check
every case first and name each mismatch); without CUDA the script exits
non-zero before printing any result.
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

from repro_torch.baselines import (AutoSteerOptimizer,  # noqa: E402
                                   LeroOptimizer)
from repro_torch.checkpoint import (Checkpointer, agent_state,  # noqa: E402
                                    agent_state_from_numpy,
                                    install_agent_state,
                                    load_reference_checkpoint, params_finite,
                                    params_from_numpy)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.agent import (AgentConfig, AqoraAgent,  # noqa: E402
                                    _node_bucket)
from repro_torch.core.dqn import DQNAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta, encode_state  # noqa: E402
from repro_torch.core.train_loop import evaluate, train_agent  # noqa: E402
from repro_torch.experiments import main_experiment  # noqa: E402
from repro_torch.gen.world import sample_world  # noqa: E402
from repro_torch.kernels import build, ops, ref, tree_conv  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.learn import (AdaptiveCurriculum, PolicyStore,  # noqa: E402
                               TrajectoryHarvester, make_online_loop)
from repro_torch.serve.deltas import DeltaBatch, apply_delta  # noqa: E402
from repro_torch.serve.drift import DriftController, RefreshPolicy  # noqa: E402
from repro_torch.serve.driver import (TenantTraffic,  # noqa: E402
                                      multi_tenant_stream, open_loop_stream)
from repro_torch.serve.obs import SloMonitor, Tracer  # noqa: E402
from repro_torch.serve.obs import export as obs_export  # noqa: E402
from repro_torch.serve.obs import report as obs_report  # noqa: E402
from repro_torch.serve.plans import PlanMemory, Superoptimizer  # noqa: E402
from repro_torch.serve.qos import (DegradationLadder,  # noqa: E402
                                   LatencyPredictor, QoSAdmission,
                                   TenantRegistry, TenantSpec)
from repro_torch.serve.recover import (FaultInjector,  # noqa: E402
                                       HedgePolicy, PolicyBreaker,
                                       RecoveryManager, RetryPolicy,
                                       ScriptedFaults)
from repro_torch.serve.scheduler import Arrival, LaneScheduler  # noqa: E402
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.catalog import analyze  # noqa: E402
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
CONTROL_SCALE = 0.25       # the control phase's db: the serving cell's
CONTROL_GROWTH_X = 24      # movie_info grows by 24x its young rows ...
CONTROL_DRIFT_AT = 24      # ... after query 24 of the 48
CONTROL_PRED_RTOL = 1e-5   # each prediction, card against CPU
REFIT_LOSS_RTOL = 1e-4     # each refit's loss, card against CPU
# the re-ANALYZE threshold: above the score the growth delta gives
# movie_info at its own barrier (24.0 in a CPU run), so the predictor's
# refits (peak score >= 1) come first; the failed retries' regret later
# lifts the score to 43.8 and the re-ANALYZE follows. At the default 1.0
# it lands at the delta's barrier and no refit can fire after it.
CONTROL_REFRESH = 30.0
TRACE_FLOAT_KEYS = ("peak_score",)   # trace fields computed from a card float
GEN_WORLD = {"family": "person", "scale": 0.07, "n_templates": 8,
             "n_train": 24, "n_test_per_template": 1, "t_min": 3,
             "t_max": 5, "n_queries": 72}   # bench_generalize's serving world
GEN_SEED, GEN_LANES = 202, 4
# the ablation experiment's workload (experiments/ablations.py, run_all)
ABLATE_WORKLOAD = {"n_train": 120, "n_test_per_template": 2, "seed": 7}
ABLATE_EPISODES = 16       # each encoder's and run_bench's AQORA training
DQN_EPISODES = 32          # the DQN agent's serial episodes
DQN_LOSS_RTOL = 1e-5       # the first train step's loss, card against CPU
DQN_SHAPE = (64, 64, 19)   # a DQN train step's batch: B, N (MAX_NODES), F
WALL_CLOCK = ("plan_time", "total")  # run_bench fields from the host clock


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
    # a DQN train step's shape (ablate phase): its own generator, so the
    # cases above keep their inputs
    drng = np.random.default_rng(64)
    dqn_case = (f"dqn/B{DQN_SHAPE[0]}/N{DQN_SHAPE[1]}/F{DQN_SHAPE[2]}",
                to_cuda(random_params(drng, DQN_SHAPE[2], H)),
                to_cuda(random_batch(drng, *DQN_SHAPE)))
    cases.append(dqn_case)

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
    dqn_timing = kernel_timing(*dqn_case[2], dqn_case[1], launches=200)
    dqn_timing["plain_ms"] = cuda_ms(lambda: ref.tree_cnn_fused_ref(
        *dqn_case[2], dqn_case[1]), launches=20)
    bwd_rows, bwd_worst, bwd_timing = backward_cases(rng, weights, real,
                                                     extra=[dqn_case])
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": worst,
          "cases": rows, "tree_cnn_fused": timing,
          "tree_cnn_fused_dqn": dqn_timing,
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


def backward_cases(rng, weights, real, extra=()):
    """Every backward case (and the `extra` ones) checked, then one error
    naming each case outside its limit; then the same inputs twice, bit
    for bit; then the kernel's time at the actor's and the critic's PPO
    shapes and at each extra case's."""
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
    cases += list(extra)
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
    timing = {c[0]: backward_timing(*c[2], c[1])
              for c in cases[:2] + list(extra)}
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


# ------------------------------------------------------------ control
def control_world(wl):
    """The serving cell's db with a young movie_info (90% of its rows
    deleted, then ANALYZEd: bench_drift's build), and the serve's 48-query
    stream with one growth delta of CONTROL_GROWTH_X times movie_info's
    young rows after query CONTROL_DRIFT_AT. Built fresh for every run:
    the delta and the re-ANALYZE mutate the db."""
    db = datagen.make_job_like(scale=CONTROL_SCALE, seed=0)
    apply_delta(db, DeltaBatch("movie_info", delete_frac=0.9, seed=7))
    db.stats = analyze(db, rng=np.random.default_rng(0))
    stream = open_loop_stream(wl.test, rate=2.0, n_queries=48, seed=1)
    rows = CONTROL_GROWTH_X * db.table("movie_info").nrows
    stream.insert(CONTROL_DRIFT_AT, Arrival(
        stream[CONTROL_DRIFT_AT - 1].t,
        delta=DeltaBatch("movie_info", n_append=rows, seed=999)))
    return db, stream, rows


def rel_distance(value, threshold) -> float:
    return abs(value - threshold) / max(abs(threshold), 1e-12)


def control_run(wl, meta, state, device, *, obs=True):
    """The serving cell under every control plane: bench_faults' `full`
    recovery arm (seeded chaos, the retry ladder, hedges against a
    predictor warm-started from the step-18 critic, a breaker over the
    run's policy store), a tracer and an SLO watchdog (alerts unwired),
    the drift controller (threshold re-ANALYZE, refits of the same
    predictor from the harvested replay), plan memory and its
    superoptimizer reading the watchdog's plan ledger. `obs=False` drops
    the tracer and the watchdog (the superoptimizer then counts its own
    heat). Every float compared against a threshold is recorded with its
    relative distance from it."""
    db, stream, rows = control_world(wl)
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    pred = LatencyPredictor(meta, agent=agent)
    side = "card" if device is None else device
    store_dir = ROOT / "build" / "chip_smoke_control" / \
        f"{side}-{'obs' if obs else 'noobs'}"
    if store_dir.exists():
        shutil.rmtree(store_dir)
    store = PolicyStore(store_dir, wl.test[:4], mode="gate")
    store.commit(agent, 18)
    harvester = TrajectoryHarvester()
    hedge = HedgePolicy(factor=4.0, predictor=pred)
    mgr = RecoveryManager(
        injector=FaultInjector(seed=23, p_crash=0.01, p_transient=0.03,
                               p_slow=0.06, p_corrupt=0.03,
                               slow_factor=(8, 48)),
        retry=RetryPolicy(max_attempts=3, backoff=0.5), hedge=hedge,
        breaker=PolicyBreaker(store, agent))
    tracer = Tracer() if obs else None
    monitor = SloMonitor(store=store) if obs else None
    ctl = DriftController(policy=RefreshPolicy("threshold",
                                               threshold=CONTROL_REFRESH),
                          replay=harvester.replay, predictor=pred,
                          store=store)
    memory = PlanMemory()
    superopt = Superoptimizer(memory, ledger=None if monitor is None
                              else monitor.ledger)
    rec = {"predictions": [], "refits": [], "fit_steps": [], "acts": [],
           "hedge_distances": [], "refit_distances": [],
           "refresh_distances": [], "margins": []}

    def forwards():
        return tree_conv.tree_cnn_fused_launches

    def backwards():
        return tree_conv.tree_cnn_fused_bwd_launches

    predict_enc, refit, fit_step = (pred.predict_enc, pred.refit_on_drift,
                                    pred._fit_step)

    def timed_predict(enc):
        f0, t0 = forwards(), time.perf_counter()
        p = predict_enc(enc)                 # ends in a device->host copy
        rec["predictions"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                   "launches": forwards() - f0, "value": p})
        return p

    def timed_refit(*a, **k):
        f0, b0, n0 = forwards(), backwards(), len(rec["fit_steps"])
        sync(device)
        t0 = time.perf_counter()
        loss = refit(*a, **k)
        sync(device)
        rec["refits"].append({"ms": (time.perf_counter() - t0) * 1e3,
                              "loss": float(loss),
                              "fit_steps": len(rec["fit_steps"]) - n0,
                              "forward_launches": forwards() - f0,
                              "backward_launches": backwards() - b0,
                              "generation": pred.generation})
        return loss

    def counted_fit_step(batch):
        b0 = backwards()
        loss = fit_step(batch)
        rec["fit_steps"].append(backwards() - b0)
        return loss
    pred.predict_enc, pred.refit_on_drift = timed_predict, timed_refit
    pred._fit_step = counted_fit_step

    should_hedge = hedge.should_hedge

    def noting_hedge(lane, n_launched):
        p = hedge.predicted(lane)
        if p is not None:
            rec["hedge_distances"].append(rel_distance(
                lane.state.elapsed, hedge.factor * p))
        return should_hedge(lane, n_launched)
    hedge.should_hedge = noting_hedge

    score = ctl.detector.score

    def noting_score(db_):
        drifts = score(db_)
        peak = max((d.score for d in drifts.values()), default=0.0)
        rec["refit_distances"].append(rel_distance(peak,
                                                   ctl.refit_threshold))
        rec["refresh_distances"].extend(
            rel_distance(d.score, ctl.policy.threshold)
            for d in drifts.values() if d.version_lag > 0)
        return drifts
    ctl.detector.score = noting_score

    if device == "cpu":
        record_margins(agent, rec["margins"])
    act_batch = agent.act_batch

    def counted_act_batch(*a, **k):
        f0 = forwards()
        out = act_batch(*a, **k)
        rec["acts"].append(forwards() - f0)
        return out
    agent.act_batch = counted_act_batch

    svc = QueryService(db, agent, n_lanes=N_LANES, policy="async",
                       recovery=mgr, obs=tracer, monitor=monitor,
                       plan_memory=memory,
                       hooks=[harvester, ctl, superopt])
    f0, b0 = forwards(), backwards()
    sync(device)
    t0 = time.perf_counter()
    comps, stats = svc.run(stream)
    sync(device)
    wall = time.perf_counter() - t0
    trace = []
    if tracer is not None:
        path = store_dir / "trace.jsonl"
        obs_export.write_trace_jsonl(tracer, str(path))
        trace = [json.loads(line) for line in path.read_text().splitlines()]
    drift = ctl.summary()
    host = {"analyze_wall_s": drift.pop("analyze_wall_s"),
            "drift_host_s": drift.pop("host_seconds")}
    so_stats = superopt.stats.as_dict()
    host["superopt_host_s"] = so_stats.pop("host_seconds")
    serve_stats = stats.as_dict()
    serve_stats.pop("hook_seconds")          # host wall time
    refit_log = [{k: v for k, v in r.items() if k != "loss"}
                 for r in pred.refit_log]
    return {
        "comps": comps, "wall": wall, "host": host, "trace": trace,
        "rows_appended": rows, "launches": {"tree_cnn_fused": forwards() - f0,
                                            "tree_cnn_fused_bwd":
                                                backwards() - b0},
        "same": {"recovery": mgr.stats.as_dict(), "drift": drift,
                 "refresh_log": ctl.refresh_log, "refit_log": refit_log,
                 "task_log": svc.scheduler.task_log,
                 "plan_memory": memory.stats(),
                 "promotions": superopt.promote_log, "superopt": so_stats,
                 "incidents": [i.as_dict() for i in monitor.incidents]
                 if monitor is not None else None,
                 "breaker_trips": mgr.breaker.trips, "service": serve_stats,
                 "versions": dict(db.versions)},
        **rec}


def sync(device) -> None:
    if device is None:
        torch.cuda.synchronize()


def completion_rows(comps):
    """What a completion decides: actions, finish time, failure kind,
    attempts, hedged, memoized, lane (and the rest of the outcome)."""
    return [(c.seq, c.query.name, tuple(c.traj.actions), c.admit_t,
             c.finish_t, c.lane, c.result.failed, c.result.failure_kind,
             c.failure_kind, c.attempts, c.recovered, c.hedged, c.memoized,
             c.first_admit_t) for c in comps]


def trace_mismatches(got, want, rtol=CONTROL_PRED_RTOL, path="trace"):
    """Where two trace exports differ: every field equal, but those in
    TRACE_FLOAT_KEYS (computed from a card float), which agree within
    `rtol` relative."""
    if isinstance(got, dict) and isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(got)} vs {sorted(want)}"]
        out = []
        for k in got:
            if k in TRACE_FLOAT_KEYS and isinstance(got[k], float):
                if not rel_distance(got[k], want[k]) <= rtol:
                    out.append(f"{path}.{k}: {got[k]} vs {want[k]}")
            else:
                out += trace_mismatches(got[k], want[k], rtol, f"{path}.{k}")
        return out
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            return [f"{path}: {len(got)} vs {len(want)} items"]
        return [m for i, (a, b) in enumerate(zip(got, want))
                for m in trace_mismatches(a, b, rtol, f"{path}[{i}]")]
    return [] if got == want else [f"{path}: {got!r} vs {want!r}"]


def breaker_rollback(wl, meta, state, device=None):
    """The breaker's rollback on the card: the step-18 agent committed as
    step 18, every parameter moved (+1e-3) and committed as step 19
    after the eighth completion, then every query admitted after the
    swap fails on every stage: the breaker trips, the store reinstalls
    step 18, and every tensor the kernels read must equal the committed
    one bit for bit; the restored agent's next act_batch launches the
    encoder and takes the committed agent's actions."""
    db = datagen.make_job_like(scale=CONTROL_SCALE, seed=0)
    agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(agent, state)
    committed = {k: v.detach().clone() for k, v in
                 flatten(agent_state(agent)) if isinstance(v, torch.Tensor)}
    store_dir = ROOT / "build" / "chip_smoke_control" / "breaker"
    if store_dir.exists():
        shutil.rmtree(store_dir)
    store = PolicyStore(store_dir, [], mode="gate")
    store.commit(agent, 18)
    n = 16
    faults = ScriptedFaults(stage={(s, 1, k): "transient"
                                   for s in range(8, n) for k in range(8)})
    brk = PolicyBreaker(store, agent, window=8, min_post=4, cooldown=5)
    sched = LaneScheduler(db, Estimator(db, db.stats), agent, n_lanes=1,
                          recovery=RecoveryManager(injector=faults,
                                                   breaker=brk))

    def swapper(comp):
        if comp.seq == 7 and store.serving_step == 18:
            with torch.no_grad():
                for p in list(agent.actor.parameters()) + \
                        list(agent.critic.parameters()):
                    p.add_(1e-3)
            store.commit(agent, 19)
    sched.on_complete.insert(0, swapper)
    comps = sched.run([Arrival(0.3 * i, query=wl.test[i % len(wl.test)],
                               seed=i + 1) for i in range(n)])
    restored = {k: v for k, v in flatten(agent_state(agent))
                if isinstance(v, torch.Tensor)}
    bad = []
    if len(brk.trips) != 1 or store.serving_step != 18:
        bad.append(f"breaker trips {brk.trips}, serving step "
                   f"{store.serving_step}")
    differ = [k for k, v in committed.items()
              if k not in restored or not torch.equal(restored[k], v)]
    on_card = all(v.device.type == agent.device.type
                  for k, v in restored.items()
                  if k.startswith(("actor", "critic")))
    if differ or not on_card:
        bad.append(f"rollback: {len(differ)} tensors differ from the "
                   f"committed state ({differ[:4]}), parameters on the "
                   f"card: {on_card}")
    batch = serving_batch(db, wl, meta)
    ref_agent = AqoraAgent(meta, AgentConfig(), seed=0, device=device)
    install_agent_state(ref_agent, state)
    f0 = tree_conv.tree_cnn_fused_launches
    amask = np.ones((N_LANES, agent.space.d), np.float32)
    keys = np.zeros((N_LANES, 2), np.uint32)
    acts = agent.act_batch(*batch, amask, keys, explore=False)[0]
    launched = tree_conv.tree_cnn_fused_launches - f0
    want = ref_agent.act_batch(*batch, amask, keys, explore=False)[0]
    if launched != (device is None) or not np.array_equal(acts, want):
        bad.append(f"restored act_batch: {launched} launches, actions "
                   f"{acts.tolist()} vs committed {want.tolist()}")
    return {"completions": len(comps), "trips": brk.trips,
            "tensors_checked": len(committed),
            "restored_bit_equal": not differ}, bad


def phase_control(wl, meta, state, card=None):
    """The control planes at the serving cell, served on the card and on
    the CPU, then on the card without the observability plane; the
    breaker's rollback on the card; both observability selftests on the
    card. Every check runs before any fails."""
    tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    got = control_run(wl, meta, state, card)
    launched = dict(got["launches"])
    want = control_run(wl, meta, state, "cpu")
    off = control_run(wl, meta, state, card, obs=False)
    bad = []
    if completion_rows(got["comps"]) != completion_rows(want["comps"]):
        bad.append("completions differ: " + "; ".join(
            f"card {a} cpu {b}" for a, b in zip(
                completion_rows(got["comps"]),
                completion_rows(want["comps"])) if a != b))
    _, logp_diff = compare_completions(got["comps"], want["comps"])
    if not logp_diff <= TOL:
        bad.append(f"logps differ by {logp_diff}")
    for name, value in got["same"].items():
        if value != want["same"][name]:
            bad.append(f"{name}: card {value} cpu {want['same'][name]}")
    bad += trace_mismatches(got["trace"], want["trace"])[:20]
    values = [p["value"] for p in got["predictions"]]
    ref_values = [p["value"] for p in want["predictions"]]
    pred_rel = max((rel_distance(a, b) for a, b in zip(values, ref_values)),
                   default=0.0)
    if len(values) != len(ref_values) or not values or \
            not pred_rel <= CONTROL_PRED_RTOL:
        bad.append(f"predictions: {len(values)} vs {len(ref_values)}, max "
                   f"relative difference {pred_rel}")
    losses = [r["loss"] for r in got["refits"]]
    ref_losses = [r["loss"] for r in want["refits"]]
    loss_rel = max((rel_distance(a, b) for a, b in zip(losses, ref_losses)),
                   default=0.0)
    if len(losses) != len(ref_losses) or not losses or \
            not loss_rel <= REFIT_LOSS_RTOL:
        bad.append(f"refits: {len(losses)} vs {len(ref_losses)}, losses "
                   f"{losses} vs {ref_losses}")
    steps = sum(r["fit_steps"] for r in got["refits"])
    if any(p["launches"] != 1 for p in got["predictions"]) or \
            any(n != 1 for n in got["acts"]) or \
            any(n != 2 for n in got["fit_steps"]) or \
            any(r["forward_launches"] != r["fit_steps"]
                for r in got["refits"]) or \
            launched["tree_cnn_fused"] != len(got["acts"]) + \
            len(values) + steps or \
            launched["tree_cnn_fused_bwd"] != 2 * steps:
        bad.append(f"launches {launched}: act_batch {got['acts']}, "
                   f"predictions {[p['launches'] for p in got['predictions']]}"
                   f", fit steps {got['fit_steps']}")
    # a replayed plan records no action masks and no log-probabilities:
    # the policy was never asked
    memoized = [c for c in got["comps"] if c.memoized]
    if not memoized or any(c.traj.masks or any(c.traj.logps)
                           for c in memoized):
        bad.append(f"{len(memoized)} memoized completions, some decided "
                   "by the policy")
    same_off = [(r, tuple(c.traj.logps)) for r, c in zip(
        completion_rows(off["comps"]), off["comps"])] == \
        [(r, tuple(c.traj.logps)) for r, c in zip(
            completion_rows(got["comps"]), got["comps"])]
    if not same_off:
        bad.append("the card's completions with obs off differ from obs on")
    breaker, breaker_bad = breaker_rollback(wl, meta, state, card)
    bad += breaker_bad
    selftests = {}
    for name, mod in (("export", obs_export), ("report", obs_report)):
        path = ROOT / "build" / "chip_smoke_control" / f"{name}.jsonl"
        f0 = tree_conv.tree_cnn_fused_launches
        rc = mod._selftest(str(path))
        selftests[name] = {"rc": rc, "launches":
                           tree_conv.tree_cnn_fused_launches - f0}
        if rc != 0 or (card is None and selftests[name]["launches"] == 0):
            bad.append(f"obs {name} selftest: {selftests[name]}")
    walls = {"card_obs_on": got["wall"], "card_obs_off": off["wall"],
             "cpu": want["wall"]}
    mean = lambda xs: float(np.mean(xs)) if xs else None  # noqa: E731
    emit({"phase": "control", "queries": 48,
          "growth_rows_appended": got["rows_appended"],
          "completed": len(got["comps"]),
          "failed": sum(c.result.failed for c in got["comps"]),
          "memoized": len(memoized),
          "hedged": sum(c.hedged for c in got["comps"]),
          "recovery": got["same"]["recovery"],
          "drift": got["same"]["drift"], "refit_log": got["same"]["refit_log"],
          "plan_memory": got["same"]["plan_memory"],
          "superopt": got["same"]["superopt"],
          "incidents": len(got["same"]["incidents"] or []),
          "breaker_trips": len(got["same"]["breaker_trips"]),
          "trace_records": len(got["trace"]),
          "wall_s": walls, "cpu_wall_s": want["wall"],
          "tracer_host_cost_s": got["wall"] - off["wall"],
          "host_clock": got["host"],
          "superopt_host_s": got["host"]["superopt_host_s"],
          "predictions": len(values),
          "predict_ms_mean": mean([p["ms"] for p in got["predictions"]]),
          "refits": len(losses),
          "refit_ms": [r["ms"] for r in got["refits"]],
          "refit_ms_mean": mean([r["ms"] for r in got["refits"]]),
          "refit_fit_steps": [r["fit_steps"] for r in got["refits"]],
          "act_batch_calls": len(got["acts"]),
          "max_prediction_rel_diff": pred_rel,
          "prediction_rtol": CONTROL_PRED_RTOL,
          "refit_losses": losses, "cpu_refit_losses": ref_losses,
          "max_refit_loss_rel_diff": loss_rel,
          "refit_loss_rtol": REFIT_LOSS_RTOL,
          "max_logp_diff": logp_diff,
          "min_top2_margin": min(want["margins"], default=None),
          "min_distance": {
              "hedge_overrun": min(got["hedge_distances"], default=None),
              "refit_threshold": min(got["refit_distances"], default=None),
              "refresh_threshold": min(got["refresh_distances"],
                                       default=None)},
          "launches": launched, "obs_off_identical": same_off,
          "breaker_rollback": breaker, "selftests": selftests,
          "identical_to_cpu": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"control phase: {bad}")
    return launched


# ---------------------------------------------------------------- gen
def gen_run(device, explore):
    """bench_generalize's serving world, freshly sampled (its deltas
    mutate the db), served by a fresh seeded agent (hidden 96, the
    reference's weights) on GEN_LANES lanes under the world's own chaos
    and a retry ladder."""
    w = sample_world(GEN_SEED, **GEN_WORLD)
    agent = AqoraAgent(w.meta, AgentConfig(), seed=0, device=device)
    margins, acts = [], []
    if device == "cpu":
        record_margins(agent, margins)
    inner = agent.act_batch

    def counted(*a, **k):
        f0 = tree_conv.tree_cnn_fused_launches
        out = inner(*a, **k)
        acts.append(tree_conv.tree_cnn_fused_launches - f0)
        return out
    agent.act_batch = counted
    mgr = RecoveryManager(injector=w.fault_injector(),
                          retry=RetryPolicy(max_attempts=3, backoff=0.5))
    svc = QueryService(w.db, agent, n_lanes=GEN_LANES, policy="async",
                       explore=explore, recovery=mgr)
    sync(device)
    t0 = time.perf_counter()
    comps, _ = svc.run(w.stream)
    sync(device)
    return {"comps": comps, "wall": time.perf_counter() - t0,
            "versions": dict(w.db.versions), "acts": acts,
            "margins": margins, "recovery": mgr.stats.as_dict(),
            "feat_dim": w.meta.feat_dim}


def phase_gen(card=None):
    """A sampled world served greedy and then exploring, on the card and
    on the CPU: completions identical, table versions equal,
    log-probabilities within TOL, one encoder launch per act_batch."""
    tree_conv.tree_cnn_fused_launches = 0
    bad, rows = [], {}
    launches = 0
    for explore in (False, True):
        f0 = tree_conv.tree_cnn_fused_launches
        got = gen_run(card, explore)
        launches += tree_conv.tree_cnn_fused_launches - f0
        want = gen_run("cpu", explore)
        mode = "explore" if explore else "greedy"
        if completion_rows(got["comps"]) != completion_rows(want["comps"]):
            bad.append(f"{mode}: completions differ")
        _, logp_diff = compare_completions(got["comps"], want["comps"])
        if not logp_diff <= TOL:
            bad.append(f"{mode}: logps differ by {logp_diff}")
        if got["versions"] != want["versions"] or \
                got["recovery"] != want["recovery"]:
            bad.append(f"{mode}: versions {got['versions']} vs "
                       f"{want['versions']}, recovery {got['recovery']} vs "
                       f"{want['recovery']}")
        if not got["acts"] or any(n != 1 for n in got["acts"]):
            bad.append(f"{mode}: forward launches per act_batch "
                       f"{got['acts']}")
        rows[mode] = {"completed": len(got["comps"]),
                      "failed": sum(c.result.failed for c in got["comps"]),
                      "deltas": sum(got["versions"].values()),
                      "recovery": got["recovery"], "wall_s": got["wall"],
                      "cpu_wall_s": want["wall"],
                      "act_batch_calls": len(got["acts"]),
                      "max_logp_diff": logp_diff,
                      "min_top2_margin": min(want["margins"], default=None)}
    emit({"phase": "gen", "world_seed": GEN_SEED, **GEN_WORLD,
          "lanes": GEN_LANES, "feat_dim": got["feat_dim"], "runs": rows,
          "launches": {"tree_cnn_fused": launches},
          "identical_to_cpu": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"gen phase: {bad}")
    return {"tree_cnn_fused": launches}


# ---------------------------------------------------------------- ablate
def ablate_deployment():
    """The ablation experiment's deployment (`experiments/ablations.py`,
    `run_all`): the ExtJOB-like db at main_experiment's SCALE (0.4) and
    `make_workload("extjob", n_train=120, n_test_per_template=2,
    seed=7)`: F = 19, 10 tables, 24 test queries."""
    db = main_experiment.make_db("extjob", 0)
    wl = workloads.make_workload("extjob", **ABLATE_WORKLOAD)
    return db, wl, WorkloadMeta.from_workload(wl)


def ablate_encoder(db, wl, meta, net):
    """One encoder of the ablation: a fresh seeded agent on the card and
    on the CPU (equal leaf for leaf), `train_agent` on each, the CPU's
    trained state installed on the card, greedy `evaluate` on each."""
    bad = []
    cfg = AgentConfig(net=net)
    agents = {dev: AqoraAgent(meta, cfg, seed=0, device=dev)
              for dev in (None, "cpu")}
    gpu, cpu = agents[None], agents["cpu"]
    a, b = leaves_of(gpu), leaves_of(cpu)
    if set(a) != set(b) or not all(np.array_equal(a[k], v)
                                   for k, v in b.items()):
        bad.append(f"{net}: a fresh seeded agent differs on the card")

    act_s, update_ms, batches = [], [], []
    act_inner, ppo_inner = gpu.act_batch, gpu.ppo_update_batch

    def act_batch(feat, left, right, mask, amask, keys, explore=True):
        t0 = time.perf_counter()
        out = act_inner(feat, left, right, mask, amask, keys,
                        explore=explore)
        act_s.append(time.perf_counter() - t0)
        if not batches:
            batches.append(tuple(np.copy(x) for x in
                                 (feat, left, right, mask, amask, keys)))
        return out

    def ppo_update_batch(trajs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ppo_inner(trajs)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        return m
    gpu.act_batch, gpu.ppo_update_batch = act_batch, ppo_update_batch

    est = Estimator(db, db.stats)
    t0 = time.perf_counter()
    _, logs = train_agent(db, wl, episodes=ABLATE_EPISODES,
                          batch_size=N_LANES, seed=0, est=est, agent=gpu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cpu_logs = train_agent(db, wl, episodes=ABLATE_EPISODES,
                              batch_size=N_LANES, seed=0, est=est, agent=cpu)
    cpu_wall = time.perf_counter() - t0
    first = [(l.query, l.actions, l.latency, l.failed)
             for l in logs[:N_LANES]]
    if first != [(l.query, l.actions, l.latency, l.failed)
                 for l in cpu_logs[:N_LANES]]:
        bad.append(f"{net}: first episode-batch differs")
    loss_rel = {k: abs(getattr(logs[0], k) - getattr(cpu_logs[0], k))
                / max(abs(getattr(cpu_logs[0], k)), 1e-12)
                for k in ("actor_loss", "critic_loss")}
    if not max(loss_rel.values()) <= TRAIN_LOSS_RTOL:
        bad.append(f"{net}: first update's losses differ by {loss_rel}")
    if not params_finite(gpu) or not all(
            np.isfinite(v).all() for v in leaves_of(gpu).values()):
        bad.append(f"{net}: a trained leaf is not finite")

    # greedy evaluation from one state: the CPU's, installed on the card
    gpu.act_batch, gpu.ppo_update_batch = act_inner, ppo_inner
    install_agent_state(gpu, agent_state(cpu))
    margins = []
    record_margins(cpu, margins)
    sync(None)
    t0 = time.perf_counter()
    rows = evaluate(db, wl.test, gpu, est=est)
    sync(None)
    eval_wall = time.perf_counter() - t0
    cpu_rows = evaluate(db, wl.test, cpu, est=est)
    keys = ("query", "actions", "latency", "failed", "shuffles", "bushy")
    if [[r[k] for k in keys] for r in rows] != \
            [[r[k] for k in keys] for r in cpu_rows]:
        bad.append(f"{net}: greedy evaluation differs")
    row = {"train_wall_s": wall, "cpu_train_wall_s": cpu_wall,
           "act_batch_calls": len(act_s),
           "act_batch_ms_mean": float(np.mean(act_s)) * 1e3,
           "act_batch_ms_median": float(np.median(act_s)) * 1e3,
           "act_batch_node_dim": gpu._trim(batches[0][3].sum(axis=1)),
           "ppo_updates": len(update_ms), "ppo_update_ms": update_ms,
           "first_update_loss_rel_diff": loss_rel,
           "eval_wall_s": eval_wall,
           "eval_failed": sum(r["failed"] for r in rows),
           "eval_latency_sum": float(sum(r["latency"] for r in rows)),
           "min_top2_margin": min(margins)}
    return row, bad, (gpu, batches[0])


def ablate_dqn(db, wl, meta):
    """`DQNAgent` through `train_agent(agent=dqn)`, serial, on the card
    and on the CPU: the episodes before the first train step identical,
    the first train step's loss within DQN_LOSS_RTOL; each greedy `act`
    on the card one forward launch, each train step two forward launches
    (q-net and target, B = 64, N = 64) and one backward call."""
    bad, runs = [], {}
    for dev in (None, "cpu"):
        dqn = DQNAgent(meta, AgentConfig(), seed=0, device=dev)
        rec = {"losses": [], "steps": [], "acts": [], "margins": [],
               "step_ms": []}
        q_inner, step_inner, act_inner = dqn._q, dqn.train_step, dqn.act
        q_calls = []

        def q(enc, q_inner=q_inner, q_calls=q_calls):
            out = q_inner(enc)
            q_calls.append(out)
            return out

        def act(enc, amask, explore=True, rec=rec, act_inner=act_inner,
                q_calls=q_calls):
            f0 = tree_conv.tree_cnn_fused_launches
            n0 = len(q_calls)
            out = act_inner(enc, amask, explore=explore)
            if len(q_calls) > n0:          # the greedy branch ran the net
                s = np.where(np.asarray(amask) > 0, q_calls[-1], -np.inf)
                top = np.sort(s)[-2:]
                rec["margins"].append(float(top[1] - top[0]))
            rec["acts"].append((len(q_calls) - n0,
                                tree_conv.tree_cnn_fused_launches - f0))
            return out

        def train_step(rec=rec, step_inner=step_inner, dev=dev):
            f0 = tree_conv.tree_cnn_fused_launches
            b0 = tree_conv.tree_cnn_fused_bwd_launches
            sync(dev)
            t0 = time.perf_counter()
            loss = step_inner()
            sync(dev)
            if loss != 0.0:
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(loss)
            rec["steps"].append((loss != 0.0,
                                 tree_conv.tree_cnn_fused_launches - f0,
                                 tree_conv.tree_cnn_fused_bwd_launches - b0))
            return loss
        dqn._q, dqn.act, dqn.train_step = q, act, train_step
        sync(dev)
        t0 = time.perf_counter()
        _, logs = train_agent(db, wl, episodes=DQN_EPISODES, seed=0,
                              est=Estimator(db, db.stats), agent=dqn)
        sync(dev)
        rec["wall"] = time.perf_counter() - t0
        rec["logs"] = logs
        rec["buffer"] = len(dqn.buffer)
        runs["card" if dev is None else "cpu"] = rec
    card, cpu = runs["card"], runs["cpu"]
    firsts = [next((i for i, l in enumerate(r["losses"]) if l != 0.0), None)
              for r in (card, cpu)]
    if firsts[0] is None or firsts[0] != firsts[1]:
        bad.append(f"dqn: first train steps {firsts}")
        first = None
    else:
        first = firsts[0]
        before = first // 4 + 1             # 4 train steps an episode
        if [(l.query, l.actions, l.latency, l.failed)
                for l in card["logs"][:before]] != \
                [(l.query, l.actions, l.latency, l.failed)
                 for l in cpu["logs"][:before]]:
            bad.append("dqn: the episodes before the first train step "
                       "differ")
        rel = abs(card["losses"][first] - cpu["losses"][first]) / \
            max(abs(cpu["losses"][first]), 1e-12)
        if not rel <= DQN_LOSS_RTOL:
            bad.append(f"dqn: first train step's loss differs by {rel}")
    if any(n != q for q, n in card["acts"]) or not any(q for q, _ in
                                                       card["acts"]):
        bad.append(f"dqn: forward launches per act {card['acts']}")
    if any((f, b) != ((2, 2) if ran else (0, 0))
           for ran, f, b in card["steps"]):
        bad.append(f"dqn: launches per train step {card['steps']}")
    row = {"episodes": DQN_EPISODES, "wall_s": card["wall"],
           "cpu_wall_s": cpu["wall"], "buffer": card["buffer"],
           "first_train_step": first,
           "first_loss": None if first is None else card["losses"][first],
           "first_loss_rel_diff": None if first is None else rel,
           "train_steps_run": len(card["step_ms"]),
           "train_step_ms_mean": float(np.mean(card["step_ms"]))
           if card["step_ms"] else None,
           "greedy_acts": sum(q for q, _ in card["acts"]),
           "acts": len(card["acts"]),
           "episodes_with_equal_actions": sum(
               a.actions == b.actions
               for a, b in zip(card["logs"], cpu["logs"])),
           "min_q_margin": min(cpu["margins"], default=None)}
    return row, bad


def score_margins(cls, margins):
    """Wrap `cls.choose` (a baseline's) so that each call appends the
    smallest gap its decision rests on: for Lero's argmin, the best score
    against the best of the candidates whose features differ from its
    own (equal features score equal on any device); for AutoSteer's
    greedy search, each prediction against the best so far. Returns the
    undo."""
    inner, score_inner = cls.choose, cls._score

    def choose(self, query):
        seen = []

        def score(x):
            seen.append((np.asarray(x).tobytes(), score_inner(self, x)))
            return seen[-1][1]
        self._score = score
        try:
            out = inner(self, query)
        finally:
            del self._score
        if cls is LeroOptimizer:
            best = min(seen, key=lambda fs: fs[1])
            rest = [s for f, s in seen if f != best[0]]
            if rest:
                margins.append(min(rest) - best[1])
        else:
            best = seen[0][1]
            for _, p in seen[1:]:
                margins.append(abs(p - best))
                best = min(best, p)
        return out
    cls.choose = choose
    return lambda: setattr(cls, "choose", inner)


def ablate_bench():
    """`main_experiment.run_bench("extjob", episodes=ABLATE_EPISODES,
    batch_size=8)` on the card (the default device) and on the CPU, its
    results under build/: Spark, Lero and AutoSteer rows identical but
    for their wall-clock fields, AQORA's first episode-batch identical."""
    bad, outs, walls = [], {}, {}
    margins = {"lero": [], "autosteer": []}
    for dev in (None, "cpu"):
        side = "card" if dev is None else "cpu"
        main_experiment.RESULTS = ROOT / "build" / "chip_smoke_results" / side
        undo = []
        if dev == "cpu":
            undo = [score_margins(LeroOptimizer, margins["lero"]),
                    score_margins(AutoSteerOptimizer, margins["autosteer"])]
        t0 = time.perf_counter()
        try:
            outs[side] = main_experiment.run_bench(
                "extjob", episodes=ABLATE_EPISODES, batch_size=N_LANES,
                quiet=True, device=dev)
        finally:
            for u in undo:
                u()
        sync(dev)
        walls[side] = time.perf_counter() - t0
    card, cpu = outs["card"], outs["cpu"]
    if card["spark"] != cpu["spark"]:
        bad.append("bench: Spark rows differ")
    for system in ("lero", "autosteer"):
        strip = [[{k: v for k, v in r.items() if k not in WALL_CLOCK}
                  for r in o[system]] for o in (card, cpu)]
        if strip[0] != strip[1] or not strip[0]:
            bad.append(f"bench: {system} rows differ")
    if card["aqora_training"][:N_LANES] != cpu["aqora_training"][:N_LANES]:
        bad.append("bench: AQORA's first episode-batch differs")
    if not (ROOT / "build" / "chip_smoke_results" / "card" /
            "extjob.json").exists():
        bad.append("bench: no results file")

    def total(rows, key="latency"):
        return float(sum(r[key] for r in rows))
    row = {"episodes": ABLATE_EPISODES,
           "baseline_episodes": main_experiment.BASELINE_EPISODES,
           "wall_s": walls["card"], "cpu_wall_s": walls["cpu"],
           "test_queries": len(card["spark"]),
           "latency_sum": {s: total(card[s]) for s in
                           ("spark", "lero", "autosteer", "aqora")},
           "failed": {s: sum(r["failed"] for r in card[s]) for s in
                      ("spark", "lero", "autosteer", "aqora")},
           "aqora_equal_to_cpu": [a["actions"] == b["actions"]
                                  for a, b in zip(card["aqora"],
                                                  cpu["aqora"])].count(True),
           "min_lero_margin": min(margins["lero"], default=None),
           "min_autosteer_margin": min(margins["autosteer"], default=None)}
    return row, bad


def phase_ablate():
    """The paper's comparison surface (Fig. 7, Fig. 9, Fig. 11, Tab. III)
    at the ablation experiment's deployment, nothing cut in width: (a)
    the LSTM, FCNN and QueryFormer agents trained (ABLATE_EPISODES
    episodes in batches of 8) and evaluated greedily on the card and the
    CPU; (b) the DQN agent through DQN_EPISODES serial episodes on each;
    (c) `main_experiment.run_bench` on each. Episode counts are cut
    (ablations.py trains 300 episodes, main_experiment 400 for ExtJOB and
    60 baseline episodes, which run_bench keeps); widths are not. Every
    case is checked before any fails. Returns the phase's kernel
    launches (every count set to 0 at its start)."""
    fa.launches = ms.launches = 0
    tree_conv.tree_conv_launches = tree_conv.tree_cnn_fused_launches = 0
    tree_conv.tree_cnn_fused_bwd_launches = 0
    db, wl, meta = ablate_deployment()
    bad, rows, profiled = [], {}, {}
    for net in ("lstm", "fcnn", "queryformer"):
        rows[net], b, profiled[net] = ablate_encoder(db, wl, meta, net)
        bad += b
    rows["dqn"], b = ablate_dqn(db, wl, meta)
    bad += b
    rows["bench"], b = ablate_bench()
    bad += b
    launched = dict(counts(),
                    tree_cnn_fused_bwd=tree_conv.tree_cnn_fused_bwd_launches)
    for k in ("tree_cnn_fused", "tree_cnn_fused_bwd"):
        if not launched[k]:
            bad.append(f"{k} never launched in the ablate phase")
    emit({"phase": "ablate", "feat_dim": meta.feat_dim,
          "tables": meta.n_tables_max, **ABLATE_WORKLOAD,
          "scale": main_experiment.SCALE, "runs": rows,
          "launches": launched, "identical_to_cpu": not bad,
          "mismatches": bad})
    if bad:
        raise AssertionError(f"ablate phase: {bad}")
    return launched, profiled


def ablate_profile(profiled):
    """Device kernels and device ms of one greedy `act_batch` of each
    encoder on its first training batch, by torch.profiler (taken after
    the ops phase, whose own profiler readings come first)."""
    out = {}
    for net, (agent, (feat, left, right, mask, amask, keys)) in \
            profiled.items():
        def call():
            agent.act_batch(feat, left, right, mask, amask, keys,
                            explore=False)
        call()
        kernels = device_kernels(call, calls=5)
        out[net] = {"device_kernels_per_act_batch": len(kernels) / 5,
                    "device_ms_per_act_batch":
                        sum(t for _, t in kernels) / 5,
                    "node_dim": agent._trim(mask.sum(axis=1))}
    return out


def phase_late_profiles(bwd_timing, agent, trajs, ablate_profiled):
    """The torch.profiler readings of the training path, taken after the
    ops phase (whose own profiler readings come first in the process):
    the backward kernel's device time at the PPO and DQN shapes, one PPO
    update's device busy time and idle share; then the `ablate_profile`
    line, each ablation encoder's device kernels an `act_batch`."""
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
    emit({"phase": "ablate_profile", "act_batch": ablate_profile(
        ablate_profiled)})


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
    control_launches = phase_control(wl, meta, state)
    gen_launches = phase_gen()
    ablate_launches, ablate_profiled = phase_ablate()
    if args.profile:
        phase_profile(db, wl, meta, params_from_numpy(tree))
    ops_launches, ops_rows = phase_ops(tree, db, wl, meta)
    phase_late_profiles(bwd_timing, trained, trajs, ablate_profiled)
    summary = [{
        "name": "tree_cnn_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused.cu",
        "replaces": "src/repro/kernels/tree_conv.py:224",
        "launches": launches + learn_launches["tree_cnn_fused"]
        + qos_launches["tree_cnn_fused"]
        + control_launches["tree_cnn_fused"]
        + gen_launches["tree_cnn_fused"]
        + ablate_launches["tree_cnn_fused"], "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "case": "step18/serving"}, {
        "name": "tree_cnn_fused_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused_bwd.cu",
        "replaces": "src/repro/kernels/tree_conv.py:202",
        "launches": train_launches["tree_cnn_fused_bwd"]
        + learn_launches["tree_cnn_fused_bwd"]
        + qos_launches["tree_cnn_fused_bwd"]
        + control_launches["tree_cnn_fused_bwd"]
        + ablate_launches["tree_cnn_fused_bwd"],
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
