"""End-to-end driver for the paper's system on the PyTorch port, the
counterpart of examples/train_aqora.py: train AQORA's decision model
against the staged engine on a JOB-like workload, then compare it with
Spark SQL's default configuration on held-out queries. The agent runs on
the CUDA card (its encoder through the fused tree-conv kernel) unless
given --device cpu.

This is the paper-kind end-to-end run (the paper optimizes query serving,
not LM pre-training): a few hundred RL episodes.

  PYTHONPATH=src python examples/torch_train_aqora.py [--episodes 200]
                                                      [--batch-size 8]
                                                      [--device cpu]

--batch-size > 1 drives training through the vectorized rollout engine:
B queries execute in lockstep, every stage boundary costs ONE batched
policy forward, and PPO replays the whole episode-batch in one
update.

--serve additionally drives the held-out queries through the online
serving subsystem (`repro_torch.serve`): open-loop arrivals into async lanes
with the LRU stage cache, reporting qps / p50 / p99 / cache hit rate.
--online extends --serve with the lifelong-learning loop (`repro_torch.learn`):
serve-time trajectory harvesting, background PPO updates, and the gated
policy hot-swap.

The final agent (params + both AdamW states) is checkpointed through
`repro_torch.checkpoint` to --ckpt-dir (under build/ by default);
--resume restores the newest valid checkpoint and continues training from
it — the same serialization path `learn.PolicyStore` uses for online
policy versions.
"""
import argparse
import logging
import pathlib
import time


from repro_torch.baselines import run_spark_default
from repro_torch.checkpoint import Checkpointer, agent_state, install_agent_state
from repro_torch.core.agent import AgentConfig, AqoraAgent
from repro_torch.core.encoding import WorkloadMeta
from repro_torch.core.train_loop import evaluate, train_agent
from repro_torch.sql import datagen, workloads
from repro_torch.sql.cbo import Estimator

log = logging.getLogger("repro_torch.train.example")
CKPT = pathlib.Path(__file__).resolve().parents[1] / "build" \
    / "torch_aqora_ckpt"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--batch-size", type=int, default=1,
                    help="lockstep rollout lanes (1 = serial path)")
    ap.add_argument("--serve", action="store_true",
                    help="also serve the test set through the async-lane "
                         "query service and print serving metrics")
    ap.add_argument("--online", action="store_true",
                    help="with --serve: harvest trajectories, train in the "
                         "background and hot-swap behind the probe gate")
    ap.add_argument("--lanes", type=int, default=4,
                    help="service lanes for --serve")
    ap.add_argument("--ckpt-dir", default=str(CKPT),
                    help="checkpoint directory for the trained agent")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint from --ckpt-dir "
                         "and continue training from it")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    log.info("building database + workload ...")
    db = datagen.make_job_like(scale=args.scale, seed=0)
    wl = workloads.make_workload("job", n_train=100, n_test_per_template=1)
    est = Estimator(db, db.stats)

    ckpt = Checkpointer(args.ckpt_dir)
    agent = AqoraAgent(WorkloadMeta.from_workload(wl), AgentConfig(), seed=0,
                       device=args.device)
    ep0 = 0
    if args.resume:
        try:
            tree, step, extra = ckpt.restore(agent_state(agent))
            install_agent_state(agent, tree)
            ep0 = extra.get("episodes", step)
            log.info(f"resumed from checkpoint step {step} "
                  f"({ep0} episodes already trained)")
        except FileNotFoundError:
            log.info(f"no checkpoint under {args.ckpt_dir}; training fresh")

    t0 = time.time()
    log.info(f"training AQORA for {args.episodes} episodes "
          f"(curriculum: cbo-only -> +runtime leads -> full) ...")
    # a resumed agent already walked the curriculum in its first run —
    # continue at the full action space instead of re-restricting it
    agent, logs = train_agent(db, wl, episodes=args.episodes, seed=ep0,
                              est=est, log_every=50, agent=agent,
                              batch_size=args.batch_size,
                              use_curriculum=(ep0 == 0))
    log.info(f"trained in {time.time()-t0:.0f}s; "
          f"decision model: {agent.param_count()} params")
    # restore picks the NEWEST step, so this run's params must land
    # strictly past whatever is on disk (a rerun into a used dir, even a
    # shorter one, must become newest) — next_step guarantees both that
    # and that save() can't silently skip an existing step
    step = ckpt.next_step(ep0 + args.episodes)
    if not ckpt.save(step, agent_state(agent),
                     extra={"episodes": ep0 + args.episodes}):
        raise RuntimeError(f"checkpoint step {step} was not written")
    log.info(f"checkpointed agent (step {step}) -> {args.ckpt_dir}")

    rows = evaluate(db, wl.test, agent, est=est)
    aq = sum(r["total"] for r in rows)
    sp = sum(run_spark_default(db, q, est).latency for q in wl.test)
    fails_aq = sum(r["failed"] for r in rows)
    log.info(f"\nheld-out test ({len(wl.test)} queries):")
    log.info(f"  Spark default : {sp:8.1f}s")
    log.info(f"  AQORA         : {aq:8.1f}s ({(sp-aq)/sp:+.1%}) "
          f"failures={fails_aq}")
    ex = next(r for r in rows if r["actions"])
    log.info(f"  example intervention on {ex['query']}: {ex['actions']}")

    if args.serve or args.online:
        from repro_torch.serve.driver import open_loop_stream
        from repro_torch.serve.service import QueryService
        hooks = []
        if args.online:
            from repro_torch.learn import make_online_loop
            harvester, learner = make_online_loop(
                agent, probe=wl.test[:4],
                store_dir=args.ckpt_dir + "/online",
                update_every=8, sample_size=8, gate_every=2, seed=0)
            hooks = [harvester, learner]
        svc = QueryService(db, agent, est=est, n_lanes=args.lanes,
                           policy="async", explore=args.online, hooks=hooks)
        stream = open_loop_stream(wl.test, rate=2.0,
                                  n_queries=3 * len(wl.test), seed=1)
        _, stats = svc.run(stream)
        log.info(f"\nonline serving ({args.lanes} async lanes, "
              f"{stats.n_completed} queries):")
        log.info(f"  qps={stats.qps:.2f} p50={stats.latency_p50:.2f}s "
              f"p99={stats.latency_p99:.2f}s fails={stats.n_failed}")
        log.info(f"  cache: {stats.cache}")
        if args.online:
            log.info(f"  learn: {learner.stats.as_dict()}")
            if learner.store is not None:
                log.info(f"  store: {learner.store.stats()}")


if __name__ == "__main__":
    main()
