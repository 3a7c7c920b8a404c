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
           version's time and the card's bound for the same work;
  serve    the repo's default deployment (JOB-like db at scale 0.25, the
           16-query test split, step-18 weights, 8 async lanes, a 48-query
           open-loop stream at 2 qps) served on the card through the
           kernels and again on the CPU through the plain versions: the
           completions must be identical and every act_batch on the card
           must have launched the encoder kernel once.

With `--profile`, one more card serve runs under `torch.profiler`: its
line gives the device's busy time by kernel and its idle share of the
wall time.

Then the kernels summary line, the `nvidia-smi` line, and the result line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero;
without CUDA the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import (load_reference_checkpoint,  # noqa: E402
                                    params_from_numpy)
from repro_torch.core.agent import (AgentConfig, AqoraAgent,  # noqa: E402
                                    _node_bucket)
from repro_torch.core.encoding import WorkloadMeta, encode_state  # noqa: E402
from repro_torch.kernels import build, tree_conv  # noqa: E402
from repro_torch.serve.driver import open_loop_stream  # noqa: E402
from repro_torch.serve.service import QueryService  # noqa: E402
from repro_torch.sql import datagen, workloads  # noqa: E402
from repro_torch.sql.cbo import Estimator  # noqa: E402
from repro_torch.sql.executor import AdaptiveRun  # noqa: E402
from repro_torch.sql.plans import syntactic_plan  # noqa: E402

CKPT = ROOT / "results" / "aqora_ckpt" / "step_00000018"
TOL = 1e-4                 # the reference's own fused-vs-jnp tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
N_LANES = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, launches: int, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `launches` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(10):
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
        ref = tree_conv.tree_cnn_fused_ref(feat, left, right, mask, params)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
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
    timing["plain_ms"] = cuda_ms(lambda: tree_conv.tree_cnn_fused_ref(
        *real, trained), launches=100)
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": worst,
          "cases": rows, "tree_cnn_fused": timing})
    return worst, timing


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
    cpu_inner = cpu.act_batch

    def margin_act_batch(feat, left, right, mask, amask, keys, explore=True):
        with torch.inference_mode():
            lg = cpu.actor(*(torch.from_numpy(np.ascontiguousarray(x))
                             for x in (feat, left, right, mask)))
            lg = lg.masked_fill(~(torch.from_numpy(amask) > 0), -1e9)
            top = lg.topk(2, dim=-1).values
            live = torch.from_numpy(np.asarray(mask).sum(axis=1) > 0)
            margins.extend((top[:, 0] - top[:, 1])[live].tolist())
        return cpu_inner(feat, left, right, mask, amask, keys, explore)
    cpu.act_batch = margin_act_batch

    tree_conv.launches = 0
    t0 = time.perf_counter()
    comps, stats = QueryService(db, gpu, n_lanes=N_LANES,
                                policy="async").run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tree_conv.launches

    t0 = time.perf_counter()
    ref_comps, ref_stats = QueryService(db, cpu, n_lanes=N_LANES,
                                        policy="async").run(stream)
    cpu_wall = time.perf_counter() - t0

    if launches != len(call_s) or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {len(call_s)} "
                             "act_batch calls")
    if len(comps) != 48 or len(ref_comps) != 48:
        raise AssertionError(f"{len(comps)}/{len(ref_comps)} completions")
    logp_diff = 0.0
    for a, b in zip(comps, ref_comps):
        same = (a.seq == b.seq and a.traj.actions == b.traj.actions
                and a.finish_t == b.finish_t and a.lane == b.lane
                and a.result.failed == b.result.failed)
        if not same:
            raise AssertionError(f"seq {a.seq}: card {a.traj.actions} "
                                 f"{a.finish_t} vs cpu {b.traj.actions} "
                                 f"{b.finish_t}")
        if not np.all(np.isfinite(a.traj.logps)):
            raise AssertionError(f"seq {a.seq}: non-finite logps")
        if a.traj.logps:
            logp_diff = max(logp_diff, float(np.max(np.abs(
                np.subtract(a.traj.logps, b.traj.logps)))))
    if logp_diff > TOL:
        raise AssertionError(f"logps differ by {logp_diff}")
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
    worst, timing = phase_kernels(db, wl, meta, tree)
    launches = phase_serve(db, wl, meta, params_from_numpy(tree))
    if args.profile:
        phase_profile(db, wl, meta, params_from_numpy(tree))
    emit({"kernels": [{
        "name": "tree_cnn_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_cnn_fused.cu",
        "replaces": "src/repro/kernels/tree_conv.py:224",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
