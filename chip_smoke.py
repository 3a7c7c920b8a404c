#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                # from the repository root
    python3 chip_smoke.py --only layout  # the layout phase alone

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
           cases' limits, atol times the std of v; the scan's are 1e-4
           for y and for its final
           state h_last, the tree conv's 1e-5);
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

Then the `lm` phase, the LM serving path (`launch.serve.BatchedServer`)
at the published configs (src/repro_torch/configs), full depth, nothing
cut: qwen3-8b (36 attention layers, every one through flash_attention)
and then falcon-mamba-7b (64 Mamba layers, every prefill through
mamba_scan), weights from torch.Generator("cuda").manual_seed(0), each
model freed before the next is built. Each serves 8 prompts of 128
tokens (default_rng(0), in [2, vocab)) and 32 greedy tokens; one
`generate` must launch flash_attention 36 * (1 + 32) = 1188 times at
qwen3-8b and mamba_scan 64 times at falcon-mamba-7b, and nothing else of
the two. Layer 0's own calls (the attention at the prefill and at the
decode steps reading 129 and 160 keys; the scan's y and h_last at the
prefill) are held to the plain versions on the card at the ops phase's
limits (ATTN_BF16; an attention call's atol scaled by the std of its v),
and two planted faults at the same calls (`planted_faults`: a causal mask
one key short, the first 64-key tile left unread) must fall outside the
same limit. The first
LM_CPU_LAYERS layers of the same weights serve 2 prompts of 32 tokens
and 4 decode steps on the card and, copied, on the CPU: every logit
within LM_LOGIT_RTOL of the CPU's largest, greedy tokens equal wherever
the top-2 margin exceeds twice that (the smallest such margin printed).
The line gives prefill and decode seconds and tok/s of a warm
`generate`, the median ms of a decode step beside its bound (the serving
copy's weights a step reads over 3.35 TB/s), the last LM_PROFILED steps
under torch.profiler (device busy ms, idle share, time by kernel; null
if the profiler returned no device events), the device ms a step spends
copying k and v out of the cache for the kernel, and peak device memory.
Every check runs before any fails. It runs after every other
torch.profiler reading.

Then the `train_lm` phase, the LM training path (`launch.train`'s
train step: `lm.loss_fn` with remat, autograd, AdamW) on the card, each
model built from torch.Generator("cuda").manual_seed(0) and freed before
the next: qwen3-8b at full width and 12 of its 36 layers (3.56 B
parameters: fp32 params, grads and both moments take 57 GB), 4 steps on
4 x 1024 tokens; falcon-mamba-7b at full width and 16 of its 64 layers, 3
steps on 2 x 512 tokens (its scan's backward is the plain version, a
Python loop over the sequence); batches from `SyntheticLMPipeline(seed=0)`,
lr 3e-4 on the driver's cosine. Each step must launch flash_attention
(or mamba_scan) exactly twice a layer, the forward and the remat
re-forward, and nothing else of the two; every loss must be finite.
Before the steps, layer 0's superblock, forward and backward, through
the kernels' autograd Functions is held against the same superblock
through the plain versions (`Tap`): the output and every gradient within
TRAIN_LAYER_TOL, each kernel call's output at the ops phase's limits;
two planted faults (one element of the call's output, one of the
gradient it returns) must take more than TRAIN_FAULT_SHARE times their
limits; and the first TRAIN_CPU_LAYERS layers against the CPU (loss and
gradient norm). The line gives ms a step (median after the first),
tokens/s, peak GB, the last step under torch.profiler (device busy ms,
idle share, top kernels), and the step's model FLOPs and their share of
989 TFLOP/s. Then `launch.train.train` itself, at the reduced
qwen1.5-4b: 6 steps with an asynchronous checkpoint, then a restore that
runs 2 more, under a temporary directory in build/; its loss must fall.

Then the `layout` phase, the layout re-optimizer and its tooling
(`launch.dryrun`, `launch.opanalysis`, `adapt/`, the policy-driven model
paths, `optim.compress.compressed_psum`) at the train_lm phase's qwen3-8b
cell (full width, LAYOUT_LAYERS layers, LAYOUT_B x LAYOUT_S tokens,
weights from torch.Generator("cuda").manual_seed(0)): one train step
counted op by op on the `meta` device and the same step counted on the
card, whose FLOPs, bytes and kernel records must be equal, and the
card's `torch.cuda.max_memory_allocated()` within LAYOUT_PEAK_RATIO of
the meta run's peak live bytes (the dry run's model FLOPs printed beside
`step_flops`); `LayoutReoptimizer.climb`
(LAYOUT_CLIMB_ITERS iterations, kind "train") on meta, each iteration's
hypothesis, predicted multipliers and terms, counted terms and verdict;
the
baseline, the climb's choice where it differs and the remat "dots" flip
run for real from the same weights and batches (a warm-up step and
LAYOUT_STEPS timed steps each: each step's loss within LAYOUT_LOSS_RTOL
of the baseline's where the layouts differ only in knobs that keep the
math, two flash_attention launches a layer a step (one with remat
"none"), step ms and peak GB beside the roofline's t_bound_s, and
whether the card orders them as the roofline does); MLA's absorbed
decode at minicpm3-4b, full width and depth, MLA_B requests over a
MLA_CACHE-token prefilled cache, with and without `mla_absorb` (logits
within MLA_LOGIT_RTOL of the largest, the step's ms both ways beside the
dry run's FLOP ratio); dbrx-132b's MoE block through the global,
block-local and `shard_map` (emulated at 16 x 16) dispatches, card
against CPU at the reduced width in fp32 with the CPU's routing imposed
(within MOE_RTOL of the largest |y|), and each dispatch's ms at full
width on 1 x MOE_TOKENS tokens; `compressed_psum` on a one-rank NCCL
group made from a HashStore, equal to quantize-then-dequantize of its
input.

With `--profile`, one more card serve runs under `torch.profiler`: its
line gives the device's busy time by kernel and its idle share of the
wall time.

Then the kernels summary line (the encoder rows' launches sum the serve,
learn, qos, control, gen and ablate phases', and the train, learn, qos,
control and ablate phases' for the backward; the attention and scan rows
the lm, train_lm, layout and ops phases'), the `nvidia-smi` line, and
the result line `{"ok": true, "device": {...}}`. Any failure raises and
exits non-zero (the learn, qos, control, gen and ablate phases check
every case first and name each mismatch); without CUDA the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
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
from repro_torch.adapt.knobs import BASELINE  # noqa: E402
from repro_torch.adapt.search import LayoutReoptimizer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.agent import (AgentConfig, AqoraAgent,  # noqa: E402
                                    _node_bucket)
from repro_torch.core.dqn import DQNAgent  # noqa: E402
from repro_torch.core.encoding import WorkloadMeta, encode_state  # noqa: E402
from repro_torch.core.train_loop import evaluate, train_agent  # noqa: E402
from repro_torch.data import SyntheticLMPipeline  # noqa: E402
from repro_torch.experiments import main_experiment  # noqa: E402
from repro_torch.gen.world import sample_world  # noqa: E402
from repro_torch.kernels import build, ops, ref, tree_conv, work  # noqa: E402,E501
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.train import batch_on  # noqa: E402
from repro_torch.launch.train import make_train_step as train_step_fn  # noqa: E402,E501
from repro_torch.launch.train import train as train_lm  # noqa: E402
from repro_torch.learn import (AdaptiveCurriculum, PolicyStore,  # noqa: E402
                               TrajectoryHarvester, make_online_loop)
from repro_torch.models import attention, blocks, lm, moe  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, global_norm  # noqa: E402,E501
from repro_torch.optim.compress import (compressed_psum,  # noqa: E402
                                        dequantize_int8, quantize_int8)
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
from repro_torch.sharding import act as act_sharding  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.catalog import analyze  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402
from repro_torch.sql.executor import AdaptiveRun  # noqa: E402
from repro_torch.sql.plans import syntactic_plan  # noqa: E402
from repro_torch.tree import flatten, tree_map, unflatten  # noqa: E402

CKPT = ROOT / "results" / "aqora_ckpt" / "step_00000018"
TOL = 1e-4                 # the reference's own fused-vs-jnp tolerance
HBM_BYTES_PER_S = work.HBM_BYTES_PER_S   # H100 SXM data sheet
FP32_FLOPS = work.FP32_FLOPS             # H100 SXM fp32, no tensor cores
BF16_FLOPS = work.BF16_FLOPS             # H100 SXM bf16 tensor cores, dense
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
    real_nodes = float(mask.sum())
    n_bytes, flops = work.tree_cnn_fused_work(B, N, F, H, real_nodes)
    return {"shape": [B, N, F, H], "real_nodes": real_nodes, "ms": ms,
            **work.bound(n_bytes, flops, FP32_FLOPS)}


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
    n_bytes, flops = work.tree_cnn_fused_bwd_work(B, N, Fd, H, real_nodes)
    return {"shape": [B, N, Fd, H], "real_nodes": real_nodes, "ms": kernel_ms,
            **{k: occupancy[k] for k in ("cluster", "blocks_per_sm",
                                         "max_active_clusters")},
            "plain_ms": plain, **work.bound(n_bytes, flops, FP32_FLOPS),
            # a later launch (phase_late_profiles) on raw pointers: `keep`
            # holds their tensors, whose memory, once freed,
            # torch.cuda.empty_cache could unmap before it
            "launch": lambda keep=(feat, left, right, mask, params, g,
                                   partial, flat): fn(*args)}


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


# --------------------------------------------------------------- lm phase
# The LM serving path (`launch.serve.BatchedServer`) at the published
# configs (src/repro_torch/configs), full depth, weights from
# torch.Generator("cuda").manual_seed(0): LM_REQUESTS prompts of LM_PROMPT
# tokens from default_rng(0) in [2, vocab), then LM_GEN greedy tokens.
LM_ARCHS = ("qwen3-8b", "falcon-mamba-7b")
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 128, 32
# layer 0's attention calls held to the plain version: the prefill and the
# decode steps that read 129 and 160 keys (the first and the last)
LM_ATTN_SK = (LM_PROMPT, LM_PROMPT + 1, LM_PROMPT + LM_GEN)
# card against CPU: the first LM_CPU_LAYERS layers of the same weights,
# LM_CPU_REQUESTS prompts cut to LM_CPU_PROMPT tokens, LM_CPU_STEPS decode
# steps fed the CPU's greedy tokens. Both sides compute in the config's
# bf16 and round it at other places (cuBLAS against the CPU's GEMMs, the
# kernel's P rounded to bf16 for P.V against the plain version's fp32
# softmax): every logit within LM_LOGIT_RTOL of the CPU's largest |logit|,
# the bf16 limit the CPU tests hold the port to against the reference
# (tests/torch_lm_cases.py); greedy tokens equal wherever the CPU's
# top-2 margin exceeds twice that.
LM_CPU_LAYERS, LM_CPU_REQUESTS, LM_CPU_PROMPT, LM_CPU_STEPS = 2, 2, 32, 4
LM_LOGIT_RTOL = 3e-2
LM_PROFILED = 4            # the last decode steps, under torch.profiler


class Recorder:
    """Stands in for one `kernels.ops` function while the main path runs:
    calls it and keeps the arguments and result of the calls `keep`
    picks. The calls launch what they launched before."""

    def __init__(self, name, keep):
        self.name, self.keep, self.calls = name, keep, {}
        self.fn = getattr(ops, name)

    def __enter__(self):
        def record(*args, **kw):
            out = self.fn(*args, **kw)
            key = self.keep(*args)
            if key is not None and key not in self.calls:
                self.calls[key] = (tuple(a.clone() if torch.is_tensor(a)
                                         else a for a in args),
                                   {k: v.clone() if torch.is_tensor(v)
                                    else v for k, v in kw.items()},
                                   out)
            return out
        setattr(ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.fn)


def planted_faults(qf, kf, vf, kw):
    """Two wrong kernels at a call's own inputs, made of the plain version
    on cut inputs: "last_key" a causal mask one key short (right-aligned,
    k and v without their last key), "first_tile" rows past the first
    64-key tile that do not read it (the rows in it, and their keys, on
    their own; then the rest without it)."""
    Sq = qf.shape[1]
    last_key = attention_plain(qf, kf[:, :-1], vf[:, :-1], **kw)
    T = 64 - (kf.shape[1] - Sq)        # the query rows within the tile
    rest = attention_plain(qf[:, max(T, 0):], kf[:, 64:], vf[:, 64:], **kw)
    first_tile = rest if T <= 0 else torch.cat(
        (attention_plain(qf[:, :T], kf[:, :64], vf[:, :64], **kw), rest), 1)
    return {"last_key": last_key, "first_tile": first_tile}


def lm_attention_checks(calls):
    """Layer 0's recorded attention calls against the plain version on
    the card, in the kernel's layout; each with the share of the same
    limit that the two planted faults take, which must exceed 1."""
    rows = []
    for Sk, ((q, k, v), kw, out) in sorted(calls.items()):
        phase = "prefill" if q.shape[1] > 1 else "decode"
        qf, kf, vf, of = flat_attention({"args": (q, k, v), "out": out})
        atol, rtol = ATTN_BF16[phase]
        row = attention_closeness(f"{phase}/Sk{Sk}", qf, kf, vf, of, kw,
                                  atol, rtol)
        want = attention_plain(qf, kf, vf, **kw)
        row["planted_limit_share"] = {
            name: closeness(name, bad, want, row["atol"],
                            rtol)["limit_share"]
            for name, bad in planted_faults(qf, kf, vf, kw).items()}
        row["ok"] = row["ok"] and min(row["planted_limit_share"].values()) > 1
        row["path"] = fa.kernel_path(qf.shape[0], kf.shape[0], qf.shape[1],
                                     Sk, qf.shape[2], qf.dtype)
        rows.append(row)
    return rows


def lm_scan_checks(calls):
    rows = []
    for key, ((x, dt, A, Bs, Cs, D), kw, (y, h)) in calls.items():
        y_want, h_want = ref.mamba_scan_ref(x, dt, A, Bs, Cs, kw.get("h0"))
        rows.append(closeness("prefill/y", y, y_want + x * D, 1e-4, 1e-4))
        rows.append(closeness("prefill/h_last", h, h_want, 1e-4, 1e-4))
    return rows


def decode_weight_bytes(serving, cfg, B) -> int:
    """Bytes of weights one decode step reads: every leaf of the serving
    copy, but for an untied embedding only the B rows it gathers."""
    total = 0
    for path, t in flatten(serving):
        if path == "embed" and not cfg.tie_embeddings:
            total += B * t.shape[1] * t.element_size()
        else:
            total += t.numel() * t.element_size()
    return total


def decode_steps(server, prompts):
    """The decode steps after a prefill of `prompts`: the median host ms
    of a step, each to a synchronize, over the first LM_GEN -
    LM_PROFILED; then the last LM_PROFILED under torch.profiler (after
    every other profiler reading of the script): device busy ms a step,
    its idle share of the steps' wall, and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg, p = server.cfg, server.serving
    toks = torch.as_tensor(prompts.astype(np.int64), device="cuda")
    times = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with torch.inference_mode():
        logits, cache = lm.prefill(p, toks, cfg, LM_PROMPT + LM_GEN)
        tok = logits.argmax(-1)[:, None]
        for t in range(LM_GEN):
            if t == LM_GEN - LM_PROFILED:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(p, tok, cache, cfg, LM_PROMPT + t)
            tok = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof.stop()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / LM_PROFILED
    wall = float(np.mean(times[-LM_PROFILED:]))
    row = {"steps": LM_PROFILED, "wall_ms": wall, "device_busy_ms": None,
           "device_idle_share": None, "by_kernel_ms": []}
    if by_kernel:          # else not measured: the profiler lost the events
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        row.update(device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
                   by_kernel_ms=[{"name": k[:80], "ms": v} for k, v in top])
    return float(np.median(times[:-LM_PROFILED])), row


def cache_copy_ms(cfg, attn_layers):
    """Device ms a decode step spends in `ops.mha_flash`'s copies of k and
    v from the cache slice into the kernel's layout, at the last step's
    LM_PROMPT + LM_GEN keys: the two copies of one layer by torch.profiler
    (the kernels' own time: CUDA events over such short launches would
    time the host), times the attention layers."""
    if not attn_layers:
        return 0.0
    K, hd = cfg.n_kv_heads, cfg.hd
    cache = torch.zeros((LM_REQUESTS, LM_PROMPT + LM_GEN, K, hd),
                        dtype=cfg.cdtype, device="cuda")

    def copies():
        for t in (cache, cache):
            t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
    copies()
    calls = 20
    kernels = device_kernels(copies, calls)
    if not kernels:        # not measured: the profiler lost the events
        return None
    return sum(t for _, t in kernels) / calls * attn_layers


def lm_card_vs_cpu(server, prompts):
    """The first LM_CPU_LAYERS layers of the server's serving copy on the
    card and, copied, on the CPU: prefill logits, then LM_CPU_STEPS decode
    steps on the CPU's greedy tokens. Returns the comparison's row."""
    cfg = dataclasses.replace(server.cfg, n_layers=LM_CPU_LAYERS)
    card = dict(server.serving,
                stack=tree_map(lambda t: t[:cfg.n_superblocks],
                               server.serving["stack"]))
    cpu = tree_map(lambda t: t.cpu(), card)
    toks = prompts[:LM_CPU_REQUESTS, :LM_CPU_PROMPT].astype(np.int64)
    runs = {}
    t0 = time.perf_counter()
    cpu_logits = []
    for side, p in (("cpu", cpu), ("cuda", card)):
        with torch.inference_mode():
            logits, cache = lm.prefill(p, torch.as_tensor(toks, device=side),
                                       cfg, LM_CPU_PROMPT + LM_CPU_STEPS)
            out = [logits.float().cpu()]
            for s in range(LM_CPU_STEPS):
                tok = (cpu_logits[s] if side == "cuda" else out[-1]) \
                    .argmax(-1)[:, None].to(side)
                logits, cache = lm.decode_step(p, tok, cache, cfg,
                                               LM_CPU_PROMPT + s)
                out.append(logits.float().cpu())
        runs[side] = out
        if side == "cpu":
            cpu_logits = out
        del cache
    limit = LM_LOGIT_RTOL * float(max(t.abs().max() for t in runs["cpu"]))
    err, margins, flips = 0.0, [], 0
    for want, got in zip(runs["cpu"], runs["cuda"]):
        err = max(err, float((got - want).abs().max()))
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        sure = margin > 2 * limit
        margins += margin[sure].tolist()
        flips += int((got.argmax(-1) != want.argmax(-1))[sure].sum())
    return {"layers": LM_CPU_LAYERS, "requests": LM_CPU_REQUESTS,
            "prompt": LM_CPU_PROMPT, "decode_steps": LM_CPU_STEPS,
            "max_abs_err": err, "limit": limit, "rtol": LM_LOGIT_RTOL,
            "ok": err <= limit and flips == 0,
            "tokens_compared": len(margins), "token_flips": flips,
            "min_compared_margin": min(margins, default=None),
            "seconds": time.perf_counter() - t0}


def lm_serve(arch, bad):
    """One model of the lm phase. Returns its row and its launches."""
    cfg = registry.get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = BatchedServer(cfg, max_batch=LM_REQUESTS, seed=0,
                           max_len=LM_PROMPT + LM_GEN, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the build's peak holds the fp32 tree and its serving copy at once
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serving_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    attn_layers = cfg.n_superblocks * sum(
        s.mixer != "mamba" and cfg.mla is None and attention.kernel_route(
            attention.MIXER_KIND[s.mixer], cfg.hd, cfg.hd)
        for s in cfg.block_pattern)
    mamba_layers = cfg.n_superblocks * sum(
        s.mixer == "mamba" for s in cfg.block_pattern)
    want = {"flash_attention": attn_layers * (1 + LM_GEN),
            "mamba_scan": mamba_layers}

    fa.launches = ms.launches = 0
    with Recorder("mha_flash", lambda q, k, v: k.shape[1]
                  if k.shape[1] in LM_ATTN_SK else None) as attn, \
            Recorder("selective_scan_fused",
                     lambda x, *a: "prefill" if x.shape[1] > 1
                     else None) as scan:
        out, _ = server.generate(prompts, LM_GEN)
    torch.cuda.synchronize()
    launched = {"flash_attention": fa.launches, "mamba_scan": ms.launches}
    if launched != want:
        bad.append(f"{arch}: a generate launched {launched}, want {want}")
    checks = lm_attention_checks(attn.calls) + lm_scan_checks(scan.calls)
    if len(checks) != (len(LM_ATTN_SK) if attn_layers else 0) \
            + (2 if mamba_layers else 0):
        bad.append(f"{arch}: recorded {len(checks)} kernel calls")
    bad += [f"{arch}: {c}" for c in checks if not c["ok"]]
    del attn, scan
    _, stats = server.generate(prompts, LM_GEN)         # warm: the times
    step_ms, step_profile = decode_steps(server, prompts)
    weight_bytes = decode_weight_bytes(server.serving, cfg, LM_REQUESTS)
    vs_cpu = lm_card_vs_cpu(server, prompts)
    if not vs_cpu["ok"]:
        bad.append(f"{arch}: card and CPU disagree: {vs_cpu}")
    row = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "reduced": [], "requests": LM_REQUESTS, "prompt": LM_PROMPT,
           "gen": LM_GEN, "launches": launched, "want_launches": want,
           "finite_tokens": bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           "sample": out[0, :8].tolist(), "build_s": build_s,
           **stats, "decode_step_ms_median": step_ms,
           "decode_step_profile": step_profile,
           "decode_cache_copy_ms": cache_copy_ms(cfg, attn_layers),
           "decode_weight_bytes": weight_bytes,
           "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "build_peak_mem_gb": build_peak_gb, "serving_mem_gb": serving_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernel_checks": checks, "card_vs_cpu": vs_cpu}
    if not row["finite_tokens"]:
        bad.append(f"{arch}: a token outside the vocabulary")
    del server
    torch.cuda.empty_cache()
    return row, launched


def phase_lm():
    """The LM serving path at full width and depth: qwen3-8b (every
    attention layer through flash_attention) and falcon-mamba-7b (every
    Mamba prefill through mamba_scan), one after the other. Every check
    runs before any fails. Returns the phase's launches."""
    bad, rows = [], []
    total = {"flash_attention": 0, "mamba_scan": 0}
    t0 = time.perf_counter()
    for arch in LM_ARCHS:
        row, launched = lm_serve(arch, bad)
        rows.append(row)
        total = {k: total[k] + launched[k] for k in total}
    emit({"phase": "lm", "models": rows, "launches": total,
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi(),
          "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"lm phase: {bad}")
    return total


# ---------------------------------------------------------- train_lm phase
# (arch, layers kept of the published depth, batch, sequence, steps): the
# published widths; the depth cut so that fp32 params, grads and both
# AdamW moments (16 B a parameter) fit one 80 GB card with the step's
# transients: qwen3-8b 12 of 36 layers (3.56 B parameters, 57 GB),
# falcon-mamba-7b 16 of 64 (2.0 B, 32 GB; fewer steps and tokens for the
# plain scan backward, a Python loop over the sequence)
TRAIN_LM_CELLS = (("qwen3-8b", 12, 4, 1024, 4),
                  ("falcon-mamba-7b", 16, 2, 512, 3))
TRAIN_LM_LR = 3e-4
# layer 0's superblock, forward and backward, through the kernels'
# autograd Functions against the same superblock through the plain
# versions, on the card, both in the config's bf16. The two differ by the
# kernels' own roundings (ATTN_BF16; the scan's 1e-4), which the layer's
# bf16 ops carry on (into the cotangents too): the output and each
# gradient (the input's and every parameter's) within TRAIN_LAYER_TOL of
# the plain one in norm, ||kernel - plain|| <= TRAIN_LAYER_TOL ||plain||
# (not elementwise: two gradients of one bf16 tensor differ by a few of
# its roundings, 2^-8 each, which an element left small by cancellation
# does not bound). Each
# kernel call's output at the ops phase's elementwise limits; the
# gradients a call's Function returns against autograd through the plain
# version on the call's own inputs and the cotangent it received, each
# within TRAIN_GRAD_RTOL of the gradient's largest |value| (the same
# ops: the Function's backward is that plain version).
TRAIN_LAYER_TOL = 2e-2
TRAIN_GRAD_RTOL = 1e-5
# a planted fault, one element of a kernel call's output (or of the
# gradient it returns for its first input) moved by the largest |value|
# of that tensor, must take more than this many times its limit
TRAIN_FAULT_SHARE = 10.0
# card against CPU: the first TRAIN_CPU_LAYERS layers of the same
# weights, the first batch cut to TRAIN_CPU_TOKENS tokens of one row:
# the loss within TRAIN_CPU_LOSS_RTOL and the gradient norm within
# TRAIN_CPU_GNORM_RTOL of the CPU's (both bf16 compute, rounded at other
# places: cuBLAS against the CPU's GEMMs, the kernels against the plain
# versions)
TRAIN_CPU_LAYERS, TRAIN_CPU_TOKENS = 2, 64
TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GNORM_RTOL = 1e-2, 5e-2
# the driver itself, `launch.train.train` at the reduced qwen1.5-4b: 6
# steps with an asynchronous checkpoint at step 3 (a blocking one at 6),
# then a restore that runs 2 more
DRIVER = {"arch": "qwen1.5-4b", "steps": 6, "global_batch": 8,
          "seq_len": 64, "ckpt_every": 3}
DRIVER_MORE = 2


def plain_mha(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """`ops.mha_flash` by the plain version, differentiable, on any
    device."""
    B, Sq, H, hd = q.shape
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, t.shape[1], hd)
                  for t in (q, k, v))
    out = ref.flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def plain_scan(x, dt, A, Bs, Cs, D_skip, h0=None):
    """`ops.selective_scan_fused` by the plain version."""
    y, h = ref.mamba_scan_ref(x, dt, A, Bs, Cs, h0)
    return y + x * D_skip, h


def bumped(t):
    """`t` with its middle element moved by the largest |value| of `t`."""
    bump = torch.zeros(t.numel(), dtype=t.dtype, device=t.device)
    bump[t.numel() // 2] = t.detach().abs().max()
    return t + bump.view(t.shape)


class Tap:
    """Stands in for `ops.mha_flash` and `ops.selective_scan_fused` while
    one superblock runs forward and backward: calls the kernel path (or,
    with `plain`, the plain versions above) and keeps each call's inputs,
    its output and, by hooks, the gradients of its inputs. `fault`
    ("out" or "grad") moves one element of the first call's output, or
    of the gradient it returns for its first input, by that tensor's
    largest |value|: a planted fault."""

    NAMES = ("mha_flash", "selective_scan_fused")

    def __init__(self, plain=False, fault=None):
        self.plain, self.fault, self.calls = plain, fault, []
        self.saved = {n: getattr(ops, n) for n in self.NAMES}

    def __enter__(self):
        for name, fn in zip(self.NAMES, (plain_mha, plain_scan)):
            setattr(ops, name, self._wrap(fn if self.plain
                                          else self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(ops, name, fn)

    def _wrap(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            rec = {"args": tuple(a.detach().clone() if torch.is_tensor(a)
                                 else a for a in args), "kw": kw,
                   "grads": {}}
            if self.fault == "out" and not self.calls:
                first = bumped(first)
                out = (first, *out[1:]) if isinstance(out, tuple) else first
            rec["out"] = first.detach().clone()
            if first.requires_grad:
                first.register_hook(self._keep_cotangent(rec))
            for i, a in enumerate(args):
                if torch.is_tensor(a) and a.requires_grad:
                    a.register_hook(self._hook(rec, i))
            self.calls.append(rec)
            return out
        return call

    @staticmethod
    def _keep_cotangent(rec):
        def keep(g):
            rec["g_out"] = g.detach().clone()
        return keep

    def _hook(self, rec, i):
        def keep(g):
            if self.fault == "grad" and i == 0 and rec is self.calls[0]:
                g = bumped(g)
            rec["grads"][i] = g.detach().clone()
            return g
        return keep


def norm_closeness(case, got, want):
    """The relative norm ||got - want|| / ||want|| against
    TRAIN_LAYER_TOL."""
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    return {"case": case, "ok": bool(torch.isfinite(got).all())
            and rel <= TRAIN_LAYER_TOL, "rel_norm_err": rel,
            "limit_share": rel / TRAIN_LAYER_TOL}


def call_grads_check(rec):
    """The gradients one kernel call's Function returned against
    autograd through the plain version on the call's own inputs and the
    cotangent it received: rows of each input's gradient, elementwise
    within TRAIN_GRAD_RTOL of its largest |value|."""
    args = [a.detach().requires_grad_(i in rec["grads"])
            if torch.is_tensor(a) else a for i, a in enumerate(rec["args"])]
    plain = plain_mha if len(args) == 3 else plain_scan
    with torch.enable_grad():
        out = plain(*args, **rec["kw"])
        first = out[0] if isinstance(out, tuple) else out
        want = torch.autograd.grad(first, [args[i] for i in rec["grads"]],
                                   rec["g_out"])
    rows = []
    for (i, got), w in zip(rec["grads"].items(), want):
        scale = TRAIN_GRAD_RTOL * float(w.float().abs().max())
        rows.append(closeness(f"call/grad{i}", got, w, max(scale, 1e-30),
                              0.0))
    return rows


def superblock0(params, cfg, tokens, tap):
    """Layer 0's superblock forward and backward on the embedded tokens,
    under `tap`, with a fixed random cotangent. Returns (output,
    {"x": input grad, path: parameter grad})."""
    sb = blocks.unstack(params["stack"], cfg.n_superblocks)[0]
    leaves = {path: t.detach().requires_grad_(True)
              for path, t in flatten(sb)}
    with torch.no_grad():
        x = lm._embed(params, tokens, cfg)
    x.requires_grad_(True)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    gen = torch.Generator(tokens.device).manual_seed(1)
    with tap:
        out, _ = blocks.apply_superblock(unflatten(sb, leaves), x, cfg,
                                         positions=positions)
        w = torch.randn(out.shape, generator=gen, device=out.device)
        grads = torch.autograd.grad((out.float() * w).sum(),
                                    [x, *leaves.values()])
    return out.detach(), dict(zip(["x", *leaves], grads))


def layer0_checks(arch, params, cfg, tokens):
    """Layer 0 through the kernels' Functions against the plain versions:
    rows for the output, every gradient, each kernel call's output and
    input gradients; then each planted fault's share of its limits."""
    def compare(kernel, plain):
        (out_k, g_k), tap_k = kernel
        (out_p, g_p), tap_p = plain
        rows = [norm_closeness("superblock/out", out_k, out_p)]
        rows += [norm_closeness(f"superblock/grad/{p}", g_k[p], g_p[p])
                 for p in g_p]
        for ck in tap_k.calls:
            if len(ck["args"]) == 3:                     # attention
                qf, kf, vf, of = flat_attention(ck)
                atol, rtol = ATTN_BF16["prefill"]
                rows.append(attention_closeness(
                    "call/attention/out", qf, kf, vf, of, ck["kw"], atol,
                    rtol))
            else:                                        # the scan, with D
                rows.append(closeness("call/scan/out", ck["out"],
                                      plain_scan(*ck["args"], **ck["kw"])[0],
                                      1e-4, 1e-4))
            rows += call_grads_check(ck)
        if len(tap_k.calls) != len(tap_p.calls) or not tap_k.calls:
            rows.append({"case": "calls", "ok": False,
                         "kernel": len(tap_k.calls),
                         "plain": len(tap_p.calls)})
        return rows

    def run(tap):
        return superblock0(params, cfg, tokens, tap), tap
    plain = run(Tap(plain=True))
    before = counts()
    kernel = run(Tap())
    after = counts()
    rows = compare(kernel, plain)
    launched = {k: after[k] - before[k] for k in after}
    if sum(launched.values()) != len(kernel[1].calls):
        rows.append({"case": "one launch a call", "ok": False,
                     "launches": launched, "calls": len(kernel[1].calls)})
    faults = {}
    for fault in ("out", "grad"):
        shares = [r.get("limit_share", float("inf"))
                  for r in compare(run(Tap(fault=fault)), plain)]
        faults[fault] = max(shares)
    ok = all(r["ok"] for r in rows) and \
        min(faults.values()) > TRAIN_FAULT_SHARE
    return {"arch": arch, "ok": ok, "launches": launched,
            "worst": max(rows, key=lambda r: r.get("limit_share",
                                                   float("inf"))),
            "bad": [r for r in rows if not r["ok"]], "checked": len(rows),
            "planted_fault_shares": faults}


def train_card_vs_cpu(params, cfg, tokens):
    """The first TRAIN_CPU_LAYERS layers of the card's weights, on the
    card and copied to the CPU: loss and gradient norm of one row of
    TRAIN_CPU_TOKENS tokens."""
    small = dataclasses.replace(cfg, n_layers=TRAIN_CPU_LAYERS)
    card = dict(params, stack=tree_map(lambda t: t[:small.n_superblocks],
                                       params["stack"]))
    toks = tokens[:1, :TRAIN_CPU_TOKENS]
    t0 = time.perf_counter()
    out = {}
    for side, p in (("cuda", card), ("cpu", tree_map(lambda t: t.cpu(),
                                                     card))):
        (loss, _), grads = loss_and_grads(p, {"tokens": toks.to(side)},
                                          small)
        out[side] = (float(loss), float(global_norm(grads)))
        del grads
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    row = {"layers": TRAIN_CPU_LAYERS, "tokens": TRAIN_CPU_TOKENS,
           "loss": {"cuda": lc, "cpu": lp, "rel": abs(lc - lp) / abs(lp),
                    "rtol": TRAIN_CPU_LOSS_RTOL},
           "grad_norm": {"cuda": gc, "cpu": gp, "rel": abs(gc - gp) / gp,
                         "rtol": TRAIN_CPU_GNORM_RTOL},
           "seconds": time.perf_counter() - t0}
    row["ok"] = row["loss"]["rel"] <= TRAIN_CPU_LOSS_RTOL and \
        row["grad_norm"]["rel"] <= TRAIN_CPU_GNORM_RTOL
    return row


def step_flops(cfg, B, S):
    """Model FLOPs of a train step (6 a weight a token for each matmul
    weight, the head's included, plus attention's 4·hd a causal query and
    key pair a head, three times), and the FLOPs the card runs: the same
    with the remat re-forwards (2 a weight a token more) and attention
    twice more."""
    T = B * S
    layer_w = sum(t.numel() for path, t in flatten(
        lm.init_params(None, cfg, device="meta")["stack"])
        if t.dim() >= 3 and not path.endswith(("conv_w", "A_log")))
    head_w = cfg.d_model * cfg.vocab_size
    attn_layers = cfg.n_superblocks * sum(
        s.mixer != "mamba" for s in cfg.block_pattern)
    attn = attn_layers * 4 * B * cfg.n_heads * cfg.hd * S * (S + 1) / 2
    model = 6 * (layer_w + head_w) * T + 3 * attn
    # + the superblocks' and the CE chunk's re-forwards, and attention
    # once more in the kernel Function's backward (the plain version's)
    return model, model + 2 * (layer_w + head_w) * T + 2 * attn


def train_cell(arch, layers, B, S, steps, bad):
    """One model of the train_lm phase: layer-0 checks, card against CPU,
    then `steps` train steps with every count at 0 before each and read
    after it. Returns the row and the launches."""
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    params = lm.init_params(gen, cfg, device="cuda")
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=0, n_logical_shards=B,
                               shard_range=(0, B))      # B rows a batch
    first = batch_on(pipe.batch_at(0), cfg, "cuda")
    torch.cuda.synchronize()
    walls["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layer0 = layer0_checks(arch, params, cfg, first["tokens"])
    if not layer0["ok"]:
        bad.append(f"{arch}: layer 0 through the kernels: {layer0}")
    walls["layer0_s"] = time.perf_counter() - t0
    vs_cpu = train_card_vs_cpu(params, cfg, first["tokens"])
    if not vs_cpu["ok"]:
        bad.append(f"{arch}: card and CPU disagree: {vs_cpu}")
    attn_layers = cfg.n_superblocks * sum(
        s.mixer != "mamba" and cfg.mla is None and attention.kernel_route(
            attention.MIXER_KIND[s.mixer], cfg.hd, cfg.hd)
        for s in cfg.block_pattern)
    mamba_layers = cfg.n_superblocks * sum(
        s.mixer == "mamba" for s in cfg.block_pattern)
    # the forward and the remat re-forward, a layer a step
    want = {"flash_attention": 2 * attn_layers,
            "mamba_scan": 2 * mamba_layers}
    step_fn = train_step_fn(cfg, AdamWConfig(lr=TRAIN_LM_LR), steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, times, per_step, profile = [], [], [], None
    for s in range(steps):
        batch = batch_on(next(pipe), cfg, "cuda")
        torch.cuda.synchronize()
        fa.launches = ms.launches = 0
        if s == steps - 1 and steps > 2:     # the last step, profiled
            profile, metrics = profiled_step(step_fn, params, opt, batch)
            params, opt = profile.pop("state")
        else:
            t0 = time.perf_counter()
            params, opt, _, metrics = step_fn(params, opt, 0, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        per_step.append({"flash_attention": fa.launches,
                         "mamba_scan": ms.launches})
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    walls["steps_s"] = time.perf_counter() - t0
    launches = {k: sum(p[k] for p in per_step) for k in want}
    if any(p != want for p in per_step):
        bad.append(f"{arch}: a step launched {per_step}, want {want}")
    if not all(np.isfinite(losses)):
        bad.append(f"{arch}: a loss is not finite: {losses}")
    step_s = float(np.median(times[1:])) if len(times) > 1 else times[0]
    model_flops, remat_flops = step_flops(cfg, B, S)
    row = {"arch": arch, "layers": layers, "published_layers":
           registry.get_config(arch).n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "reduced": [f"n_layers {layers} of "
                       f"{registry.get_config(arch).n_layers}"],
           "batch": B, "seq": S, "steps": steps, "lr": TRAIN_LM_LR,
           "losses": losses, "step_s": times, "step_ms_median":
           step_s * 1e3, "tokens_per_s": B * S / step_s,
           "peak_mem_gb": peak, "launches_per_step": per_step,
           "want_launches_per_step": want,
           "model_tflop": model_flops / 1e12,
           "model_tflop_with_remat": remat_flops / 1e12,
           "mfu_bf16": model_flops / step_s / BF16_FLOPS,
           "hfu_bf16_with_remat": remat_flops / step_s / BF16_FLOPS,
           "step_floor_ms": remat_flops / BF16_FLOPS * 1e3,
           "profiled_step": profile, "layer0": layer0, "card_vs_cpu": vs_cpu,
           "walls": walls}
    del params, opt, step_fn
    torch.cuda.empty_cache()
    return row, launches


def profiled_step(step_fn, params, opt, batch):
    """One train step under torch.profiler: wall ms to a synchronize,
    device busy ms (the sum of its kernels: one stream), idle share and
    the top kernels by device time. Device activity only: falcon's step
    runs ~250 k kernels, and the host ops' events would take minutes to
    read back. The events are read once; null where none came back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, metrics = step_fn(params, opt, 0, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    row = {"wall_ms": wall, "device_busy_ms": None,
           "device_idle_share": None, "by_kernel_ms": [],
           "read_s": time.perf_counter() - t0 - wall / 1e3,
           "state": (params, opt)}
    if by_kernel:
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        by_class = {}
        for name, t in by_kernel.items():
            c = kernel_class(name)
            by_class[c] = by_class.get(c, 0.0) + t
        row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
                   device_kernels=len(by_kernel), by_class_ms=by_class,
                   by_kernel_ms=[{"name": k[:80], "ms": v} for k, v in top])
    return row, metrics


def kernel_class(name: str) -> str:
    """A device kernel's class by its name: the port's two LM kernels,
    cuBLAS products, reductions, or elementwise and copies."""
    for kernel in ("flash_wgmma_kernel", "flash_decode_kernel",
                   "flash_f32_kernel", "mamba_scan_kernel"):
        if kernel in name:
            return kernel
    if any(k in name for k in ("gemm", "nvjet", "xmma", "gemv", "cutlass")):
        return "matmul"
    if "reduce_kernel" in name:
        return "reduction"
    return "elementwise and copies"


def train_driver(bad):
    """`launch.train.train` itself on the card at the reduced qwen1.5-4b:
    DRIVER's steps with an asynchronous checkpoint, then a restore that
    runs DRIVER_MORE more; a temporary directory under build/."""
    cfg = registry.reduced(registry.get_config(DRIVER["arch"]))
    per_step = 2 * cfg.n_superblocks * len(cfg.block_pattern)
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        kw = {k: v for k, v in DRIVER.items() if k != "steps"}
        fa.launches = ms.launches = 0
        _, losses = train_lm(**kw, steps=DRIVER["steps"], ckpt_dir=tmp,
                             log_every=0, device="cuda")
        launched = fa.launches
        on_disk = Checkpointer(tmp).steps()
        _, more = train_lm(**kw, steps=DRIVER["steps"] + DRIVER_MORE,
                           ckpt_dir=tmp, restore=True, log_every=0,
                           device="cuda")
        after = Checkpointer(tmp).steps()
    row = {"arch": DRIVER["arch"] + " (reduced)", **DRIVER,
           "losses": losses, "launches": launched,
           "want_launches": per_step * DRIVER["steps"],
           "checkpoints": on_disk, "restored_losses": more,
           "checkpoints_after_restore": after,
           "seconds": time.perf_counter() - t0}
    row["ok"] = (launched == row["want_launches"]
                 and all(np.isfinite(losses + more))
                 and losses[-1] < losses[0]
                 and on_disk == [DRIVER["ckpt_every"], DRIVER["steps"]]
                 and len(more) == DRIVER_MORE
                 and after[-1] == DRIVER["steps"] + DRIVER_MORE)
    if not row["ok"]:
        bad.append(f"train driver: {row}")
    return row, launched


def phase_train_lm():
    """The LM training path on the card: each TRAIN_LM_CELLS model at
    full width (cut depth), then the driver. Every check runs before any
    fails. Returns the phase's launches."""
    bad, rows = [], []
    total = {"flash_attention": 0, "mamba_scan": 0}
    t0 = time.perf_counter()
    for cell in TRAIN_LM_CELLS:
        row, launched = train_cell(*cell, bad)
        rows.append(row)
        total = {k: total[k] + launched[k] for k in total}
    driver, launched = train_driver(bad)
    total["flash_attention"] += launched
    emit({"phase": "train_lm", "models": rows, "driver": driver,
          "launches": total, "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi(), "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"train_lm phase: {bad}")
    return total


# ------------------------------------------------------------ layout phase
# the dry run against the card at the train_lm phase's qwen3-8b cell:
# full width, LAYOUT_LAYERS of 36 layers, LAYOUT_B x LAYOUT_S tokens
LAYOUT_ARCH, LAYOUT_LAYERS, LAYOUT_B, LAYOUT_S = "qwen3-8b", 12, 4, 1024
LAYOUT_CLIMB_ITERS = 4
# the card's max_memory_allocated over the dry run's peak live bytes: the
# allocator holds every live tensor (at least 1, less a little for
# tensors the count sees and the allocator does not, such as host
# scalars) plus its 512-byte rounding, cuBLAS's workspaces and blocks
# freed but not yet reused (1.0011 in the first card run, PERF.md)
LAYOUT_PEAK_RATIO = (0.99, 1.02)
LAYOUT_STEPS = 2           # timed steps a layout, after one warm-up step
# the layouts run for real differ only in knobs that leave the step's math
# as it is (remat, ce_chunk, attn_remat; the sharding-only attn_mode and
# kv_seq_shard are no-ops on one card): each step's loss within this of
# the baseline's
LAYOUT_LOSS_RTOL = 1e-2
MATH_KNOBS = ("grad_compress", "mla_absorb", "attn_scores_bf16",
              "moe_dispatch")
# MLA's absorbed decode at minicpm3-4b, full width and depth: B requests
# over a cache of MLA_CACHE tokens; logits within MLA_LOGIT_RTOL of the
# largest |logit| of the expanded path (the lm phase's limit)
MLA_ARCH, MLA_B, MLA_CACHE, MLA_LOGIT_RTOL = "minicpm3-4b", 8, 2048, 3e-2
MLA_REPS = 5
# dbrx-132b's MoE block: full width at 1 x MOE_TOKENS; the gate at the
# reduced width (fp32 compute), card against CPU with the CPU's routing
MOE_ARCH, MOE_TOKENS, MOE_MESH = "dbrx-132b", 2048, (16, 16)
MOE_SMALL_TOKENS, MOE_RTOL = 256, 1e-4
MOE_MODES = ("global", "local", "shard_map")


def layout_cfg():
    return dataclasses.replace(registry.get_config(LAYOUT_ARCH),
                               n_layers=LAYOUT_LAYERS)


def layout_shape():
    return ShapeConfig("train_lm", LAYOUT_S, LAYOUT_B, "train")


def layout_state(cfg):
    """Parameters from torch.Generator("cuda").manual_seed(0), fresh AdamW
    state, and the pipeline's first LAYOUT_STEPS + 1 batches (tokens only:
    the dry run's batch), all on the card."""
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    params = lm.init_params(gen, cfg, device="cuda")
    opt = adamw_init(params, getattr(torch, cfg.opt_moment_dtype))
    pipe = SyntheticLMPipeline(vocab_size=cfg.vocab_size, seq_len=LAYOUT_S,
                               global_batch=LAYOUT_B, seed=0,
                               n_logical_shards=LAYOUT_B,
                               shard_range=(0, LAYOUT_B))
    batches = [{"tokens": torch.as_tensor(pipe.batch_at(i)["tokens"],
                                          device="cuda")}
               for i in range(LAYOUT_STEPS + 1)]
    return params, opt, batches


def op_classes(counter):
    """A count's ops, FLOPs and bytes by class, each as its share of the
    total: AdamW's `_foreach` passes, matmuls, casts and copies, the
    other elementwise ops and reductions, and the kernels' records."""
    out = {"kernels": {"ops": len(counter.kernels),
                       "flops": sum(k["flops"] for k in counter.kernels),
                       "bytes": sum(k["bytes"] for k in counter.kernels)}}
    for name, (n, flops, n_bytes) in counter.by_op.items():
        c = ("adamw _foreach" if name.startswith("_foreach") else
             "matmul" if name in ("mm", "addmm", "bmm", "baddbmm") else
             "casts and copies" if name in ("_to_copy", "copy_", "clone")
             else "other elementwise and reductions")
        r = out.setdefault(c, {"ops": 0, "flops": 0, "bytes": 0})
        r["ops"] += n
        r["flops"] += flops
        r["bytes"] += n_bytes
    for r in out.values():
        r["flops_share"] = r["flops"] / counter.flops
        r["bytes_share"] = r["bytes"] / counter.bytes
    return out


def layout_dry_vs_card(cfg, bad):
    """One train step counted on meta and the same step counted on the
    card: FLOPs, bytes and the kernels' records must be equal. Returns the
    row and the card's flash_attention launches."""
    shape = layout_shape()
    t0 = time.perf_counter()
    meta, meta_mem, meta_s = dryrun.count_step(cfg, shape, BASELINE)
    params, opt, batches = layout_state(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    card, card_mem, card_s = dryrun.count_step(
        cfg, shape, BASELINE, inputs=(params, opt, batches[0]))
    torch.cuda.synchronize()
    launched = fa.launches
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batches
    torch.cuda.empty_cache()
    model_flops = rl.model_flops(cfg, shape, dryrun._useful_params(cfg))
    same = {"flops": meta.flops == card.flops,
            "bytes": meta.bytes == card.bytes,
            "kernels": meta.kernel_totals() == card.kernel_totals()}
    row = {"arch": LAYOUT_ARCH, "layers": LAYOUT_LAYERS,
           "batch": LAYOUT_B, "seq": LAYOUT_S, "layout": BASELINE.name(),
           "meta": {"flops": meta.flops, "bytes": meta.bytes,
                    "ops": meta.ops, "kernels": meta.kernel_totals(),
                    "peak_live_bytes": meta.peak_live_bytes,
                    "argument_bytes": meta_mem["argument"],
                    "by_class": op_classes(meta), "seconds": meta_s},
           "card": {"flops": card.flops, "bytes": card.bytes,
                    "ops": card.ops, "kernels": card.kernel_totals(),
                    "peak_live_bytes": card.peak_live_bytes,
                    "max_memory_allocated": peak, "seconds": card_s},
           "equal": same,
           "peak_ratio_card_over_meta": peak / meta.peak_live_bytes,
           "model_flops": model_flops,
           "step_flops": step_flops(cfg, LAYOUT_B, LAYOUT_S)[0],
           "model_over_step_flops": model_flops
           / step_flops(cfg, LAYOUT_B, LAYOUT_S)[0],
           "launches": launched, "want_launches": 2 * cfg.n_layers,
           "seconds": time.perf_counter() - t0}
    if not all(same.values()):
        bad.append(f"dry run and card count differ: {same}")
    lo, hi = LAYOUT_PEAK_RATIO
    if not lo <= row["peak_ratio_card_over_meta"] <= hi:
        bad.append(f"card peak over the dry run's: "
                   f"{row['peak_ratio_card_over_meta']} outside {lo}-{hi}")
    if launched != row["want_launches"]:
        bad.append(f"the counted card step launched {launched}, want "
                   f"{row['want_launches']}")
    return row, launched


class CutReoptimizer(LayoutReoptimizer):
    """The re-optimizer on the cut train_lm cell: each evaluation is the
    port's dry run at `cfg` and `shape`."""

    def __init__(self, cfg, shape, out_dir):
        super().__init__(cfg.name, shape.name, out_dir=out_dir)
        self.cfg, self.shape_cfg = cfg, shape

    def evaluate(self, layout):
        return dryrun.run_cell(self.arch, self.shape, verbose=False,
                               layout=layout, cfg=self.cfg,
                               shape=self.shape_cfg)


def layout_climb(cfg):
    t0 = time.perf_counter()
    opt = CutReoptimizer(cfg, layout_shape(),
                         ROOT / "build" / "chip_smoke_perf")
    best, logs = opt.climb(max_iters=LAYOUT_CLIMB_ITERS, kind="train")
    terms = ("compute", "memory", "collective")
    rows = [{"iteration": l.iteration, "hypothesis": l.hypothesis,
             "layout": l.layout, "predicted_multipliers": l.predicted,
             "predicted": {k: l.before[k] * l.predicted[k] for k in terms}
             if l.predicted else None,
             "before": l.before, "counted": l.after, "verdict": l.verdict}
            for l in logs]
    return best, {"chosen": best.name(), "iterations": rows,
                  "seconds": time.perf_counter() - t0}


def math_same(a, b) -> bool:
    return all(getattr(a, k) == getattr(b, k) for k in MATH_KNOBS)


def layout_run(cfg, layout):
    """A warm-up step and LAYOUT_STEPS timed steps of `layout` on the card
    from the seeded weights and the same batches; the step's roofline from
    the dry run."""
    params, opt, batches = layout_state(cfg)
    step = steps_lib.step_fn(cfg, layout_shape())
    if layout.grad_compress:
        step = steps_lib.make_train_step(cfg, grad_compress=True)
    pol = dryrun.layout_policy(make_production_mesh(), layout)
    losses, times, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with act_sharding.policy(pol):
        for i, batch in enumerate(batches):
            fa.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            launches.append(fa.launches)
            losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    del params, opt, batches
    torch.cuda.empty_cache()
    rec = dryrun.run_cell(cfg.name, "train_lm", verbose=False, layout=layout,
                          cfg=cfg, shape=layout_shape())
    mode = "none" if layout.remat == "none" else "remat"
    want = (1 if mode == "none" else 2) * cfg.n_layers
    return {"layout": layout.name(), "losses": losses, "step_s": times,
            "step_ms_median": float(np.median(times)) * 1e3,
            "peak_gb": peak / 1e9, "launches_per_step": launches,
            "want_launches_per_step": want,
            "t_bound_s": rec["roofline"]["t_bound_s"],
            "bottleneck": rec["roofline"]["bottleneck"],
            "counted_peak_gb": rec["memory"]["live_bytes_per_device"] / 1e9}


def layout_runs(cfg, best, bad):
    """The baseline, the climb's choice (where it differs) and the remat
    "dots" flip, run for real."""
    layouts = [BASELINE]
    if best.name() != BASELINE.name():
        layouts.append(best)
    dots = dataclasses.replace(BASELINE, remat="dots")
    if all(dots.name() != l.name() for l in layouts):
        layouts.append(dots)
    runs = [layout_run(cfg, l) for l in layouts]
    base = runs[0]
    for lay, run in zip(layouts, runs):
        run["loss_gate"] = math_same(lay, BASELINE)
        if run["loss_gate"]:
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(run["losses"], base["losses"]))
            run["loss_rel_to_baseline"] = rel
            if rel > LAYOUT_LOSS_RTOL or not all(np.isfinite(run["losses"])):
                bad.append(f"layout {run['layout']}: losses {run['losses']} "
                           f"against the baseline's {base['losses']}")
        if any(n != run["want_launches_per_step"]
               for n in run["launches_per_step"]):
            bad.append(f"layout {run['layout']}: launched "
                       f"{run['launches_per_step']} a step")
    by_card = sorted(range(len(runs)), key=lambda i: runs[i]["step_ms_median"])
    by_roof = sorted(range(len(runs)), key=lambda i: runs[i]["t_bound_s"])
    return runs, {"card_order": [runs[i]["layout"] for i in by_card],
                  "roofline_order": [runs[i]["layout"] for i in by_roof],
                  "same_order": by_card == by_roof}


def reset_heads(cache, pos):
    for entry in cache.values():
        if "pos" in entry:
            entry["pos"].fill_(pos)


def layout_mla(bad):
    """minicpm3-4b at full width and depth: a decode step of MLA_B
    requests over a MLA_CACHE-token cache (prefilled from random prompts),
    with and without mla_absorb, on the same cache."""
    cfg = registry.get_config(MLA_ARCH)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    serving = lm.serving_params(lm.init_params(gen, cfg, device="cuda"), cfg)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    P = MLA_CACHE - 1
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (MLA_B, P)),
                              dtype=torch.int32, device="cuda")
    token = torch.as_tensor(rng.integers(2, cfg.vocab_size, (MLA_B, 1)),
                            dtype=torch.int32, device="cuda")
    out = {}
    with torch.inference_mode():
        _, cache = lm.prefill(serving, prompts, cfg, MLA_CACHE)
        for name, absorb in (("expanded", False), ("absorbed", True)):
            pol = act_sharding.ActivationPolicy(mla_absorb=absorb)
            with act_sharding.policy(pol):
                def one():
                    reset_heads(cache, P)
                    return lm.decode_step(serving, token, cache, cfg, P)[0]
                logits = one().float()
                ms_step = cuda_ms(one, launches=1, reps=MLA_REPS, warmup=2)
            out[name] = (logits, ms_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del serving, cache
    torch.cuda.empty_cache()
    (want, ms_x), (got, ms_a) = out["expanded"], out["absorbed"]
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    shape = ShapeConfig("decode_2k", MLA_CACHE, MLA_B, "decode")
    recs = {name: dryrun.run_cell(
        MLA_ARCH, shape.name, verbose=False, cfg=cfg, shape=shape,
        layout=dataclasses.replace(BASELINE, mla_absorb=absorb))
        for name, absorb in (("expanded", False), ("absorbed", True))}
    flops = {k: r["hlo_analysis"]["flops"] for k, r in recs.items()}
    row = {"arch": MLA_ARCH, "layers": cfg.n_layers, "batch": MLA_B,
           "cache": MLA_CACHE, "params": cfg.param_count(),
           "max_abs_err": err, "largest_logit": top,
           "rel_err": err / top, "rtol": MLA_LOGIT_RTOL,
           "finite": bool(torch.isfinite(got).all()),
           "argmax_equal_share": float(
               (got.argmax(-1) == want.argmax(-1)).float().mean()),
           "decode_ms": {"expanded": ms_x, "absorbed": ms_a},
           "card_speedup": ms_x / ms_a,
           "dry_run_flops": flops,
           "dry_run_flop_ratio": flops["expanded"] / flops["absorbed"],
           "dry_run_t_bound_ms": {k: r["roofline"]["t_bound_s"] * 1e3
                                  for k, r in recs.items()},
           "peak_gb": peak, "seconds": time.perf_counter() - t0}
    if not row["finite"] or err > MLA_LOGIT_RTOL * top:
        bad.append(f"MLA absorbed decode: {row}")
    return row


def moe_case(cfg, T, device, gen):
    """One MoE layer's parameters and a (1, T, D) input on `device`,
    from `gen` (bf16 at full width: the serving copy)."""
    p = moe.init_moe(gen, cfg, device=device)
    p = {k: v.to(cfg.cdtype) if k.startswith("moe_w") else v
         for k, v in p.items()}
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=device)
    return p, x.to(cfg.cdtype)


def moe_policy(mode):
    dp, tp = MOE_MESH
    return act_sharding.ActivationPolicy(
        dp_size=dp, tp_size=tp, moe_dispatch=mode,
        mesh=make_production_mesh())


def layout_moe(bad):
    """dbrx-132b's MoE block through the global, block-local and
    shard_map dispatches: card against CPU at the reduced width with the
    CPU's routing imposed, then each dispatch's time at full width."""
    t0 = time.perf_counter()
    full = registry.get_config(MOE_ARCH)
    small = dataclasses.replace(
        registry.reduced(full), compute_dtype="float32",
        moe=dataclasses.replace(registry.reduced(full).moe,
                                n_experts=full.moe.n_experts,
                                top_k=full.moe.top_k))
    gen = torch.Generator().manual_seed(0)
    p_cpu, x_cpu = moe_case(small, MOE_SMALL_TOKENS, "cpu", gen)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    rows = {}
    for mode in MOE_MODES:
        with act_sharding.policy(moe_policy(mode)), torch.inference_mode():
            routed = []
            real_route = moe.route

            def keep(probs, K):
                routed.append(real_route(probs, K))
                return routed[-1]
            moe.route = keep
            try:
                want, _ = moe.apply_moe(p_cpu, x_cpu, small)
            finally:
                moe.route = real_route
            gate, eidx = routed[0]
            moe.route = lambda probs, K: (gate.to(probs.device),
                                          eidx.to(probs.device))
            try:
                got, _ = moe.apply_moe(p_gpu, x_cpu.cuda(), small)
            finally:
                moe.route = real_route
        err = float((got.cpu() - want).abs().max())
        top = float(want.abs().max())
        rows[mode] = {"max_abs_err": err, "largest": top,
                      "rel_err": err / top, "rtol": MOE_RTOL}
        if not err <= MOE_RTOL * top:
            bad.append(f"MoE {mode} dispatch: card and CPU differ: "
                       f"{rows[mode]}")
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    p, x = moe_case(full, MOE_TOKENS, "cuda", gen)
    outs = {}
    with torch.inference_mode():
        for mode in MOE_MODES:
            with act_sharding.policy(moe_policy(mode)):
                outs[mode] = moe.apply_moe(p, x, full)[0].float()
                rows[mode]["ms"] = cuda_ms(
                    lambda: moe.apply_moe(p, x, full), launches=1, reps=5,
                    warmup=2)
                rows[mode]["finite"] = bool(torch.isfinite(outs[mode]).all())
    for mode in MOE_MODES:
        rows[mode]["rel_norm_to_global"] = float(
            (outs[mode] - outs["global"]).norm() / outs["global"].norm())
        if not rows[mode]["finite"]:
            bad.append(f"MoE {mode} dispatch at full width is not finite")
    expert_gb = sum(p[k].numel() * p[k].element_size()
                    for k in ("moe_wg", "moe_wu", "moe_wd")) / 1e9
    del p, x, outs
    torch.cuda.empty_cache()
    return {"arch": MOE_ARCH, "experts": full.moe.n_experts,
            "top_k": full.moe.top_k, "d_model": full.d_model,
            "d_ff": full.moe_d_ff, "tokens": MOE_TOKENS,
            "mesh": list(MOE_MESH), "expert_gb": expert_gb,
            "gate_at": {"d_model": small.d_model, "d_ff": small.moe_d_ff,
                        "tokens": MOE_SMALL_TOKENS, "dtype": "float32"},
            "dispatch": rows, "seconds": time.perf_counter() - t0}


def layout_psum(bad):
    """compressed_psum on a one-rank NCCL group made from a HashStore:
    the sum of one rank is its own quantize-then-dequantize."""
    import torch.distributed as dist
    x = torch.randn((1024, 1024), generator=torch.Generator(
        "cuda").manual_seed(3), device="cuda") * 3
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        got = compressed_psum(x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    q, s = quantize_int8(x)
    want = dequantize_int8(q, s)
    row = {"shape": list(x.shape), "equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max())}
    if not row["equal"]:
        bad.append(f"compressed_psum: {row}")
    return row


def phase_layout():
    """The layout re-optimizer and its tooling on the card (see the
    module docstring). Every check runs before any fails. Returns the
    phase's flash_attention launches."""
    bad = []
    t0 = time.perf_counter()
    cfg = layout_cfg()
    dry, launched = layout_dry_vs_card(cfg, bad)
    best, climb = layout_climb(cfg)
    runs, order = layout_runs(cfg, best, bad)
    launched += sum(sum(r["launches_per_step"]) for r in runs)
    mla = layout_mla(bad)
    moe_row = layout_moe(bad)
    psum = layout_psum(bad)
    emit({"phase": "layout", "dry_run_vs_card": dry, "climb": climb,
          "runs": runs, "order": order, "mla_absorb": mla, "moe": moe_row,
          "compressed_psum": psum, "launches": {"flash_attention": launched},
          "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi(),
          "ok": not bad, "mismatches": bad})
    if bad:
        raise AssertionError(f"layout phase: {bad}")
    return {"flash_attention": launched}


# -------------------------------------------------------------- ops phase
# (case, B, Sq, Sk, H, K, hd, causal, window, softcap, dtype, atol, rtol,
#  the one SDPA call that computes the same function: "is_causal" (top-left
#  causal, the same when Sq = Sk), "full" (no mask: one right-aligned query
#  sees every key), "mask" (an explicit boolean right-aligned causal
#  attn_mask), or None)
# A case holds |kernel - plain| <= atol * std(v) + rtol * |plain|
# everywhere (attention_closeness): attention is linear in v, so atol is
# stated for v of unit std, as the ops cases draw it, and a model's call
# scales it by the std of its own v (1.28 at qwen3-8b's layer 0). In
# bf16, rtol covers one rounding of the output (at most 2^-7 |x|) and atol
# the kernel's P rounded to bf16 for the P.V product, which shows in the
# rows with few keys (the first rows of prefill and gemma2); the decode
# cases' rows all see 4093 to 4096 keys. Each ops case's atol is at least
# 1.8 times what the sound kernel needs (PERF.md); a kernel that drops one
# 64-key tile, or one split's partial in the decode merge, fails at decode.
ATTN_BF16 = {"prefill": (4e-3, 1e-2), "decode": (1e-3, 1e-2)}
ATTENTION_CASES = (
    ("qwen3-8b/prefill", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, *ATTN_BF16["prefill"], "is_causal"),
    ("qwen3-8b/decode", 8, 1, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, *ATTN_BF16["decode"], "full"),
    ("gemma2-27b/local", 1, 8192, 8192, 32, 16, 128, True, 4096, 50.0,
     torch.bfloat16, *ATTN_BF16["prefill"], None),  # SDPA has no softcap
    ("qwen3-8b/fp32", 1, 1024, 1024, 32, 8, 128, True, 0, 0.0,
     torch.float32, 2e-5, 2e-5, "is_causal"),
    ("gemma2-27b/decode-local", 8, 1, 8192, 32, 16, 128, True, 4096, 50.0,
     torch.bfloat16, *ATTN_BF16["decode"], None),   # SDPA has no softcap
    ("qwen3-8b/suffix4", 8, 4, 4096, 32, 8, 128, True, 0, 0.0,
     torch.bfloat16, *ATTN_BF16["decode"], "mask"),  # chunked decode
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


def attention_closeness(case, qf, kf, vf, out, kw, atol, rtol):
    """`closeness` of a kernel's output to the plain version's, with atol
    (stated for v of unit std) times the std of v."""
    v_std = float(vf.float().std())
    row = closeness(case, out, attention_plain(qf, kf, vf, **kw),
                    atol * v_std, rtol)
    row["v_std"] = v_std
    return row


def attention_check(a):
    return attention_closeness(a["case"], *flat_attention(a), a["kw"],
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
    pairs = work.allowed_pairs(Sq, Sk, a["kw"]["causal"], a["kw"]["window"])
    n_bytes, flops = work.attention_work(
        B * H, kf.shape[0], Sq, Sk, hd, causal=a["kw"]["causal"],
        window=a["kw"]["window"], itemsize=qf.element_size())
    peak = BF16_FLOPS if a["dtype"] == torch.bfloat16 else FP32_FLOPS
    row = {"case": a["case"], "entry": "mha_flash",
           "kernel": "flash_attention",
           "path": fa.kernel_path(B * H, kf.shape[0], Sq, Sk, hd, qf.dtype),
           "q": list(a["args"][0].shape), "kv": list(a["args"][1].shape),
           **a["kw"], "dtype": str(a["dtype"]),
           "allowed_pairs_per_head": pairs, "ms": ms_kernel,
           "plain_ms": plain, **work.bound(n_bytes, flops, peak),
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
    """y and h_last of one selective_scan_fused call against the plain
    version; the row is y's, failing if either is outside the limit."""
    x, dt, A, Bs, Cs, D = scan
    y_want, h_want = ref.mamba_scan_ref(x, dt, A, Bs, Cs)
    row = closeness(case, out[0], y_want + x * D, 1e-4, 1e-4)
    h = closeness(case + "/h_last", out[1], h_want, 1e-4, 1e-4)
    row["h_last"] = h
    row["ok"] = row["ok"] and h["ok"]
    return row


def device_kernels(fn, calls: int = 1, sessions: int = 3):
    """(name, device ms) of each device kernel that `calls` calls of `fn`
    run, by torch.profiler. A session that comes back with no device
    event at all lost them (seen on an H100 at the ops phase's scan op,
    in one run of this script): it is taken again, up to
    `sessions` times, and an empty list means not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            return kernels
    return []


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
    h_last = torch.empty((x.shape[0], x.shape[2], A.shape[1]),
                         device=x.device)
    ms_kernel = cuda_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, h_last, D),
                        launches=5, warmup=3)
    dev_ms = device_ms(lambda: ms._launch(x, dt, A, Bs, Cs, y, h_last, D),
                       calls=5)
    op_ms = cuda_ms(lambda: ops.selective_scan_fused(*scan), launches=5,
                    warmup=3)
    kernels = [k for k, _ in device_kernels(
        lambda: ops.selective_scan_fused(*scan))]
    plain = cuda_ms(lambda: ref.mamba_scan_ref(x, dt, A, Bs, Cs), launches=1,
                    reps=3, warmup=1)
    B, S, di = x.shape
    N = A.shape[1]
    n_bytes, flops = work.scan_work(B, S, di, N)
    return {"case": case, "entry": "selective_scan_fused",
            "kernel": "mamba_scan", "x": list(x.shape), "A": list(A.shape),
            "dtype": "torch.float32", "ms": ms_kernel, "device_ms": dev_ms,
            "op_ms": op_ms,
            "device_kernels_per_op": len(kernels),
            "device_kernel_names": sorted(set(k[:60] for k in kernels)),
            "plain_ms": plain, **work.bound(n_bytes, flops, FP32_FLOPS),
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
    n_bytes, flops = work.tree_conv_work(B, N, Fd, H, float(mask.sum()))
    return {"case": case, "entry": "tree_conv_batch", "kernel": "tree_conv",
            "shape": [B, N, Fd, H], "dtype": "torch.float32",
            "ms": ms_kernel, "device_ms": dev_ms, "plain_ms": plain,
            **work.bound(n_bytes, flops, FP32_FLOPS), "sfu_ms": 0.0,
            "library_ms": None, "library_note": "none"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one serve on the card")
    ap.add_argument("--only", choices=["layout"], default=None,
                    help="run the device, build and this phase alone, "
                         "with no summary or result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 as the reference
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    if args.only == "layout":
        phase_layout()
        return 0
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
    lm_launches = phase_lm()
    train_lm_launches = phase_train_lm()
    layout_launches = phase_layout()
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
            "replaces": replaces,
            "launches": ops_launches[name] + lm_launches.get(name, 0)
            + train_lm_launches.get(name, 0)
            + layout_launches.get(name, 0),
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
