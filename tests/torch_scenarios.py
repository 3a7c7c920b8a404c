"""The port's side of tests/scenarios.py, for the port's parity tests.

`scenarios.py` builds its worlds from the reference's classes. `port_of`
carries what it builds (queries, arrivals, delta batches, whole streams)
over to the port's classes field for field, so both packages serve the
very same inputs. The scripted agents take the package they build for:
`pkg` is "repro" or "repro_torch" throughout, and `P(pkg, "serve.obs")`
imports that package's module, so one scenario body runs on either.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

PKGS = ("repro", "repro_torch")


def P(pkg: str, name: str):
    """`pkg`'s module `name` (e.g. P("repro_torch", "serve.recover"))."""
    return importlib.import_module(f"{pkg}.{name}")


def port_of(obj):
    """`obj` rebuilt from the port's classes: every dataclass instance of
    a `repro` module becomes the same-named class of the matching
    `repro_torch` module, recursively through lists, tuples and dicts;
    anything else is returned as it is."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        if mod.startswith("repro."):
            cls = getattr(importlib.import_module("repro_torch" + mod[5:]),
                          type(obj).__name__)
            return cls(**{f.name: port_of(getattr(obj, f.name))
                          for f in dataclasses.fields(obj) if f.init})
        return obj
    if isinstance(obj, list):
        return [port_of(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(port_of(x) for x in obj)
    if isinstance(obj, dict):
        return {k: port_of(v) for k, v in obj.items()}
    return obj


def plain(obj):
    """`obj` with every dataclass instance turned into (class name, its
    fields), recursively: results of the two packages compare equal when
    they hold the same values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(x) for x in obj)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


def both(fn, *args, **kw):
    """`plain(fn(pkg, ...))` for the reference and for the port."""
    return [plain(fn(pkg, *args, **kw)) for pkg in PKGS]


def of(pkg: str, obj):
    """`obj` (built from the reference's classes) for package `pkg`."""
    return obj if pkg == "repro" else port_of(obj)


def arrivals(items):
    """Reference `Arrival`s from (t, query or delta batch, seed) triples."""
    from repro.serve.deltas import DeltaBatch
    from repro.serve.scheduler import Arrival
    return [Arrival(t, delta=x, seed=s) if isinstance(x, DeltaBatch)
            else Arrival(t, query=x, seed=s) for t, x, s in items]


def fresh_db(pkg: str, scale: float = 0.06, seed: int = 0):
    return P(pkg, "sql.datagen").make_job_like(scale=scale, seed=seed)


def world(pkg: str, scale: float = 0.06, seed: int = 0):
    db = fresh_db(pkg, scale, seed)
    return db, P(pkg, "sql.cbo").Estimator(db, db.stats)


def meta_for(pkg: str, queries, max_tables: int = 3):
    wl = P(pkg, "sql.workloads").Workload(
        name="scenario", max_tables=max_tables,
        train=[of(pkg, q) for q in queries], test=[])
    return P(pkg, "core.encoding").WorkloadMeta.from_workload(wl)


class ScriptedServeAgent:
    """scenarios.NoopServeAgent, built from `pkg`'s classes."""

    def __init__(self, pkg: str, meta, max_steps: int = 1):
        self.meta = meta
        self.cfg = P(pkg, "core.agent").AgentConfig(max_steps=max_steps)
        self.space = P(pkg, "core.actions").ActionSpace(meta.n_tables_max,
                                                        self.cfg.families)

    def act_batch(self, feat, left, right, mask, amask, keys, *,
                  explore: bool = False):
        B = amask.shape[0]
        acts = np.full(B, self.space.noop_idx, np.int32)
        return acts, np.zeros(B, np.float32), keys

    def act(self, enc, am, *, explore: bool = False):
        a, lp, _ = self.act_batch(None, None, None, None, am[None],
                                  np.zeros((1, 2), np.uint32))
        return int(a[0]), float(lp[0])


def noop_agent_for(pkg: str, *queries, max_steps: int = 1,
                   max_tables: int = 3) -> ScriptedServeAgent:
    """scenarios.noop_agent_for in `pkg`'s classes."""
    return ScriptedServeAgent(pkg, meta_for(pkg, queries, max_tables),
                              max_steps=max_steps)


def cold_agent(pkg: str, workload, seed: int = 0, **cfg_kw):
    """scenarios.make_agent in `pkg`: the seeded serving agent (the port's
    on the CPU draws the reference's weights, leaf for leaf)."""
    meta = P(pkg, "core.encoding").WorkloadMeta.from_workload(workload)
    cfg = P(pkg, "core.agent").AgentConfig(**cfg_kw)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    return P(pkg, "core.agent").AqoraAgent(meta, cfg, seed=seed, **kw)


def job_workload(pkg: str):
    """conftest's `job_workload` in `pkg`."""
    return P(pkg, "sql.workloads").make_workload(
        "job", n_train=24, n_test_per_template=1, seed=7)


def comp_key(c):
    """Everything a completion decides, bar its log-probabilities."""
    return (c.seq, c.query.name, c.tenant, c.arrival_t, c.admit_t,
            c.finish_t, c.lane, c.result.latency, c.result.failed,
            c.result.failure_kind, c.attempts, c.recovered, c.hedged,
            c.failure_kind, c.first_admit_t, c.memoized, c.slo_miss,
            tuple(c.traj.actions))


def max_logp_diff(comps, ref_comps) -> float:
    out = 0.0
    for a, b in zip(comps, ref_comps):
        if len(a.traj.logps):
            out = max(out, float(np.max(np.abs(
                np.subtract(a.traj.logps, b.traj.logps)))))
    return out
