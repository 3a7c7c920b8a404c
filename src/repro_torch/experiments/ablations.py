"""Ablation + dynamic-evaluation experiments (paper Fig. 9, Fig. 11,
Tab. III). Each variant trains on ExtJOB (as in §VII-D) and evaluates on
its test set; dynamic eval trains on IMDb-1950/-1980 snapshots of the JOB
workload and tests on the full database (§VII-B5), plus the cross-workload
transfers. Results land in results/aqora_torch/ablations.json
(resumable), beside the reference's results/aqora/. Every learned
component runs on `device`: None (the default) means CUDA and raises
without one; `--device cpu` takes the plain path.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import time

import numpy as np

from repro_torch.baselines import LeroOptimizer, run_spark_default
from repro_torch.core.agent import AgentConfig, AqoraAgent
from repro_torch.core.dqn import DQNAgent
from repro_torch.core.encoding import WorkloadMeta
from repro_torch.core.train_loop import evaluate, train_agent
from repro_torch.experiments.main_experiment import SCALE, make_db
from repro_torch.sql import datagen, workloads
from repro_torch.sql.cbo import Estimator
from repro_torch.sql.cluster import ClusterModel

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "aqora_torch"
EPISODES = 300


def _summ(rows):
    return {"total": sum(r["total"] for r in rows),
            "exec": sum(r["latency"] for r in rows),
            "plan": sum(r["plan_time"] for r in rows),
            "fails": sum(r["failed"] for r in rows),
            "per_query": rows}


def _train_eval(db, wl, cfg: AgentConfig, *, episodes=EPISODES, seed=0,
                agent=None, use_curriculum=True, test_db=None, test_est=None,
                track_curve=True, device=None):
    est = Estimator(db, db.stats)
    agent, logs = train_agent(db, wl, episodes=episodes, seed=seed, cfg=cfg,
                              est=est, agent=agent,
                              use_curriculum=use_curriculum, device=device)
    rows = evaluate(test_db if test_db is not None else db, wl.test,
                    agent, est=test_est or est)
    out = _summ(rows)
    if track_curve:
        lat = [l.latency for l in logs]
        out["curve"] = [float(np.mean(lat[i:i + 30]))
                        for i in range(0, len(lat), 30)]
        out["train_fail_curve"] = [int(np.sum([l > 299 for l in lat[i:i + 30]]))
                                   for i in range(0, len(lat), 30)]
    return out


def run_all(force=False, device=None):
    train_eval = functools.partial(_train_eval, device=device)
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / "ablations.json"
    out = json.loads(path.read_text()) if path.exists() and not force else {}

    db = make_db("extjob", 0)
    wl = workloads.make_workload("extjob", n_train=120,
                                 n_test_per_template=2, seed=7)

    def save():
        path.write_text(json.dumps(out))

    def todo(k):
        return k not in out

    t0 = time.time()
    # ---------------- Fig 11(a): PPO vs DQN
    if todo("rl_ppo"):
        out["rl_ppo"] = train_eval(db, wl, AgentConfig())
        save(); print("rl_ppo done", int(time.time() - t0))
    if todo("rl_dqn"):
        meta = WorkloadMeta.from_workload(wl)
        dqn = DQNAgent(meta, AgentConfig(), seed=0, device=device)
        out["rl_dqn"] = train_eval(db, wl, AgentConfig(), agent=dqn)
        save(); print("rl_dqn done", int(time.time() - t0))

    # ---------------- Fig 11(b)/Tab III: encoder ablation
    for net in ("lstm", "fcnn", "queryformer"):
        k = f"net_{net}"
        if todo(k):
            r = train_eval(db, wl, AgentConfig(net=net))
            # optimization overhead: mean hook seconds per eval query
            out[k] = r
            save(); print(k, "done", int(time.time() - t0))

    # ---------------- Fig 11(c): strategy ablation
    if todo("strat_no_step_limit"):
        out["strat_no_step_limit"] = train_eval(
            db, wl, AgentConfig(max_steps=8))
        save(); print("strat_no_step_limit done", int(time.time() - t0))
    if todo("strat_no_curriculum"):
        out["strat_no_curriculum"] = train_eval(
            db, wl, AgentConfig(), use_curriculum=False)
        save(); print("strat_no_curriculum done", int(time.time() - t0))

    # ---------------- §VII-D4: action-space ablation
    for name, fams in (("act_plus_broadcast", ("cbo", "lead", "broadcast", "noop")),
                       ("act_no_lead", ("cbo", "noop")),
                       ("act_no_cbo", ("lead", "noop")),
                       ("act_plus_swap", ("cbo", "lead", "swap", "noop"))):
        if todo(name):
            out[name] = train_eval(db, wl, AgentConfig(families=fams))
            save(); print(name, "done", int(time.time() - t0))

    # ---------------- Fig 9 row 1: data-evolution (train old, test full)
    full_db = make_db("job", 0)
    wl_job = workloads.make_workload("job", n_train=120,
                                     n_test_per_template=2, seed=7)
    for year in (1950, 1980):
        k = f"dyn_imdb{year}"
        if todo(k):
            old_db = datagen.make_job_like(scale=SCALE, seed=0, year_max=year)
            test_est = Estimator(full_db, old_db.stats)   # STALE stats
            out[k] = {
                "aqora": train_eval(old_db, wl_job, AgentConfig(),
                                     test_db=full_db, test_est=test_est,
                                     track_curve=False),
            }
            lero = LeroOptimizer(old_db, Estimator(old_db, old_db.stats),
                                 device=device)
            rng = np.random.default_rng(0)
            for _ in range(50):
                lero.train_episode(wl_job.train[int(rng.integers(len(wl_job.train)))])
            lero.db, lero.est = full_db, test_est
            out[k]["lero"] = _summ([
                {"query": q.name, "latency": (r := lero.run(q)).latency,
                 "plan_time": r.plan_time, "total": r.total,
                 "failed": r.failed} for q in wl_job.test])
            out[k]["spark"] = _summ([
                {"query": q.name, "latency": (r := run_spark_default(
                    full_db, q, test_est)).latency, "plan_time": 0.0,
                 "total": r.latency, "failed": r.failed}
                for q in wl_job.test])
            save(); print(k, "done", int(time.time() - t0))

    # ---------------- Fig 9 row 2: cross-workload transfer
    if todo("dyn_job_to_extjob"):
        est = Estimator(full_db, full_db.stats)
        agent, _ = train_agent(full_db, wl_job, episodes=EPISODES, seed=0,
                               cfg=AgentConfig(), est=est, device=device)
        out["dyn_job_to_extjob"] = _summ(
            evaluate(full_db, wl.test, agent, est=est))
        save(); print("dyn_job_to_extjob done", int(time.time() - t0))
    if todo("dyn_extjob_to_job"):
        est = Estimator(full_db, full_db.stats)
        agent, _ = train_agent(full_db, wl, episodes=EPISODES, seed=0,
                               cfg=AgentConfig(), est=est, device=device)
        out["dyn_extjob_to_job"] = _summ(
            evaluate(full_db, wl_job.test, agent, est=est))
        save(); print("dyn_extjob_to_job done", int(time.time() - t0))

    # ---------------- Fig 3: CBO planning-cost blowup
    if todo("cbo_cost"):
        from repro_torch.sql.cbo import dp_join_order
        rows = []
        for q in sorted(wl_job.test, key=lambda q: q.n_relations):
            est = Estimator(full_db, full_db.stats)
            t_dp = dp_join_order(q, est)[1] if q.n_relations <= 12 else None
            from repro_torch.sql.plans import syntactic_plan
            from repro_torch.sql.executor import run_adaptive
            from repro_torch.sql.cbo import cbo_plan
            r0 = run_adaptive(full_db, q, syntactic_plan(q), est)
            p1, t1 = cbo_plan(q, est)
            r1 = run_adaptive(full_db, q, p1, est)
            rows.append({"query": q.name, "n": q.n_relations,
                         "plan_time": t1, "exec_no_cbo": r0.latency,
                         "exec_cbo": r1.latency})
        out["cbo_cost"] = rows
        save(); print("cbo_cost done", int(time.time() - t0))
    print("ablations complete")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args()
    run_all(force=args.force, device=args.device)
