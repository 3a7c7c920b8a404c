"""Main experiment runner: AQORA + 3 baselines on 3 benchmarks (§VII).

Writes results/aqora_torch/<bench>.json incrementally (resumable), beside
the reference's results/aqora/, which it never writes. Every learned
component (AQORA's agent, Lero's and AutoSteer's scorers) runs on
`device`: None (the default) means CUDA and raises without one;
`--device cpu` takes the plain path. Run:

  PYTHONPATH=src python -m repro_torch.experiments.main_experiment --bench job
  PYTHONPATH=src python -m repro_torch.experiments.main_experiment --all
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np

from repro_torch.baselines import AutoSteerOptimizer, LeroOptimizer, run_spark_default
from repro_torch.core.agent import AgentConfig
from repro_torch.core.train_loop import evaluate, train_agent
from repro_torch.sql import datagen, workloads
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "aqora_torch"

SCALE = 0.4
EPISODES = {"job": 700, "extjob": 400, "stack": 450}
BASELINE_EPISODES = 60
N_TRAIN = {"job": 160, "extjob": 120, "stack": 120}
N_TEST_PER_TEMPLATE = {"job": 3, "extjob": 2, "stack": 4}


def make_db(bench: str, seed: int = 0, year_max=None):
    if bench in ("job", "extjob"):
        return datagen.make_job_like(scale=SCALE, seed=seed, year_max=year_max)
    return datagen.make_stack_like(scale=SCALE, seed=seed)


def run_bench(bench: str, seed: int = 0, episodes=None, out_name=None,
              train_db=None, test_db=None, quiet=False,
              batch_size: int = 1, device=None) -> dict:
    t_start = time.time()
    db = train_db if train_db is not None else make_db(bench, seed)
    tdb = test_db if test_db is not None else db
    wl = workloads.make_workload(bench, n_train=N_TRAIN[bench],
                                 n_test_per_template=N_TEST_PER_TEMPLATE[bench],
                                 seed=7 + seed)
    est = Estimator(db, db.stats)
    test_est = Estimator(tdb, db.stats)   # stats from TRAIN-era snapshot
    cluster = ClusterModel()
    episodes = episodes or EPISODES[bench]
    rng = np.random.default_rng(seed)

    out = {"bench": bench, "scale": SCALE, "episodes": episodes}

    # ---------------- Spark default
    sp = []
    for q in wl.test:
        r = run_spark_default(tdb, q, test_est, cluster)
        sp.append({"query": q.name, "latency": r.latency, "plan_time": 0.0,
                   "total": r.latency, "failed": r.failed,
                   "shuffles": r.total_shuffles, "bushy": r.bushy})
    out["spark"] = sp
    if not quiet:
        print(f"[{bench}] spark done ({time.time()-t_start:.0f}s)")

    # ---------------- Lero
    lero = LeroOptimizer(db, est, seed=seed, cluster=cluster, device=device)
    for i in range(BASELINE_EPISODES):
        lero.train_episode(wl.train[int(rng.integers(len(wl.train)))])
    lr = []
    lero.est = test_est
    lero.db = tdb
    for q in wl.test:
        r = lero.run(q)
        lr.append({"query": q.name, "latency": r.latency,
                   "plan_time": r.plan_time, "total": r.total,
                   "failed": r.failed, "shuffles": r.total_shuffles,
                   "bushy": r.bushy})
    out["lero"] = lr
    if not quiet:
        print(f"[{bench}] lero done ({time.time()-t_start:.0f}s)")

    # ---------------- AutoSteer
    ast = AutoSteerOptimizer(db, est, seed=seed, cluster=cluster,
                             device=device)
    for i in range(BASELINE_EPISODES):
        ast.train_episode(wl.train[int(rng.integers(len(wl.train)))], rng)
    ar = []
    ast.est = test_est
    ast.db = tdb
    for q in wl.test:
        r = ast.run(q)
        ar.append({"query": q.name, "latency": r.latency,
                   "plan_time": r.plan_time, "total": r.total,
                   "failed": r.failed, "shuffles": r.total_shuffles,
                   "bushy": r.bushy})
    out["autosteer"] = ar
    if not quiet:
        print(f"[{bench}] autosteer done ({time.time()-t_start:.0f}s)")

    # ---------------- AQORA
    agent, logs = train_agent(db, wl, episodes=episodes, seed=seed,
                              cfg=AgentConfig(), cluster=cluster, est=est,
                              batch_size=batch_size,
                              log_every=0 if quiet else 60, device=device)
    aq = evaluate(tdb, wl.test, agent, est=test_est, cluster=cluster)
    out["aqora"] = aq
    out["aqora_training"] = [
        {"episode": l.episode, "latency": l.latency, "failed": l.failed,
         "stage": l.stage} for l in logs]
    out["agent_params"] = agent.param_count()
    out["wall_seconds"] = time.time() - t_start
    if not quiet:
        print(f"[{bench}] aqora done ({time.time()-t_start:.0f}s)")

    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / f"{out_name or bench}.json").write_text(json.dumps(out))
    return out


def main():
    # train_loop progress goes through logging ("repro_torch.train"); opt in so
    # hour-long runs keep printing per-episode progress
    import logging
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="lockstep rollout lanes for AQORA training "
                         "(1 = the paper's per-query replay; >1 pools "
                         "updates per episode-batch)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args()
    benches = ["job", "extjob", "stack"] if args.all else [args.bench]
    for b in benches:
        out = RESULTS / f"{b}.json"
        if out.exists() and not args.force:
            print(f"skip cached {b}")
            continue
        run_bench(b, batch_size=args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
