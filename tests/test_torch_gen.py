"""The port's world generator (gen/) against the reference's, on the CPU,
and a sampled world served through both packages (ROADMAP A10's gate).

`sample_schema`, `make_gen_workload`, `build_stream` and `sample_world`
give the reference's specs, queries, profiles and arrivals over seeds
that cover all three schema families, and the materialized databases
hold the same columns array for array with the same statistics. Then a
sampled world is served by a fresh seeded agent (hidden 96, the
reference's weights) through both packages, with the world's own fault
injector and a retry ladder, greedy and then exploring: completions are
identical and log-probabilities agree within 1e-4. Exact equality of
actions only means something away from near ties, so each run also
asserts the port's smallest top-1/top-2 margin of the scores it took its
actions from (masked logits greedy, Gumbel-perturbed logits exploring).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_scenarios import P, PKGS, both, comp_key, max_logp_diff  # noqa: E402

LOGP_ATOL = 1e-4
MIN_MARGIN = 1e-4


def gen_world(pkg, seed, **kw):
    return P(pkg, "gen.world").sample_world(seed, **kw)


def db_columns(db):
    """Every table's columns in insertion order, and its statistics."""
    cols = [(t, c, arr) for t, tab in db.tables.items()
            for c, arr in tab.columns.items()]
    stats = {t: (ts.nrows, sorted((c, cs.n_distinct, cs.min_val, cs.max_val)
                                  for c, cs in ts.columns.items()))
             for t, ts in db.stats.tables.items()}
    return cols, stats, dict(db.versions)


@pytest.mark.parametrize("seed", range(6))
def test_samplers_match_reference(seed):
    """The schema (three families forced in turn, and the sampled one),
    the workload, the stream profile and the arrivals of a world; the
    reference's seeds, `substream` and train/test split."""
    def samplers(pkg):
        S, Q = P(pkg, "gen.schema"), P(pkg, "gen.queries")
        specs = [S.sample_schema(seed, family=f) for f in S.FAMILIES] + \
            [S.sample_schema(seed)]
        wl = Q.make_gen_workload(specs[seed % 3], 100 + seed, n_templates=5,
                                 n_train=8, n_test_per_template=1)
        w = gen_world(pkg, seed, n_templates=4, n_train=8, t_min=3, t_max=5,
                      n_queries=16, materialize=False)
        inj = w.fault_injector()
        G = P(pkg, "gen.seeds")
        return (specs, wl.train, wl.test, w.spec, w.workload.train,
                w.workload.test, w.meta.table_index, w.meta.feat_dim,
                w.profile, w.stream, None if inj is None else
                (inj.seed, inj.window), G.split_train_test(seed),
                G.substream(seed, 3))
    ref, port = both(samplers)
    assert port == ref
    assert len(port[9]) > 0


def test_stream_renderer_matches_reference():
    def render(pkg):
        S, Q, St = (P(pkg, "gen.schema"), P(pkg, "gen.queries"),
                    P(pkg, "gen.streams"))
        spec = S.sample_schema(0, family="star")
        wl = Q.make_gen_workload(spec, 1, n_templates=4, n_train=8,
                                 n_test_per_template=1)
        profile = St.StreamProfile(
            n_queries=24, rate=4.0, n_tenants=2, slos=(None, 100.0),
            delta_every=4, delta_rows=500, delete_frac=0.1,
            delta_tables=P(pkg, "gen.spec").delete_safe_tables(spec),
            burst=(0.5, 3.0, 4), faults=())
        return St.build_stream(wl, profile, seed=3)
    ref, port = both(render)
    assert port == ref
    assert sum(a[1]["delta"] is not None for a in port) == 6


@pytest.mark.parametrize("family", ["star", "snowflake", "person"])
def test_materialized_world_matches_reference(family):
    """The database of a sampled world, column for column: the same
    dtypes and values, the same statistics and versions."""
    kw = dict(family=family, scale=0.04, n_templates=4, n_train=8, t_min=3,
              t_max=5, n_queries=12)
    ref, port = [gen_world(pkg, 5, **kw) for pkg in PKGS]
    (cols, stats, versions), (rcols, rstats, rversions) = \
        db_columns(port.db), db_columns(ref.db)
    assert [(t, c) for t, c, _ in cols] == [(t, c) for t, c, _ in rcols]
    for (t, c, a), (_, _, b) in zip(cols, rcols):
        assert a.dtype == b.dtype and np.array_equal(a, b), (t, c)
    assert stats == rstats and versions == rversions
    assert port.db.name == ref.db.name


# ------------------------------------------------- serving: A10's gate
def record_margins(agent, out):
    """Wrap the port agent's `act_batch` so each live decision appends the
    top-1/top-2 margin of the scores its action comes from."""
    inner = agent.act_batch
    prng = P("repro_torch", "core.prng")

    def act_batch(feat, left, right, mask, amask, keys, explore=False):
        with torch.inference_mode():
            lg = agent.actor(*(agent._tensor(x)
                               for x in (feat, left, right, mask)))
            s = lg.masked_fill(~(agent._tensor(amask) > 0), -1e9)
        if explore:
            u = prng.gumbel_uniforms(prng.split(keys)[:, 1], s.shape[-1])
            s = -torch.log(-torch.log(torch.from_numpy(u))) + s
        top = s.topk(2, dim=-1).values
        live = torch.from_numpy(np.asarray(mask).sum(axis=1) > 0)
        out.extend((top[:, 0] - top[:, 1])[live].tolist())
        return inner(feat, left, right, mask, amask, keys, explore=explore)
    agent.act_batch = act_batch


def serve_world(pkg, seed, explore, margins=None):
    """A freshly sampled world (its deltas mutate the db) served by a
    fresh seeded agent on 4 lanes under the world's chaos and a retry
    ladder."""
    w = gen_world(pkg, seed, scale=0.04, n_templates=6, n_train=12, t_min=3,
                  t_max=5, n_queries=20)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    A = P(pkg, "core.agent")
    agent = A.AqoraAgent(w.meta, A.AgentConfig(), seed=0, **kw)
    if margins is not None:
        record_margins(agent, margins)
    R = P(pkg, "serve.recover")
    mgr = R.RecoveryManager(injector=w.fault_injector(),
                            retry=R.RetryPolicy(max_attempts=3, backoff=0.5))
    svc = P(pkg, "serve.service").QueryService(
        w.db, agent, n_lanes=4, explore=explore, recovery=mgr)
    comps, stats = svc.run(w.stream)
    d = stats.as_dict()
    d.pop("hook_seconds")                             # host wall time
    return comps, d, mgr.stats.as_dict(), dict(w.db.versions), \
        w.meta.feat_dim


@pytest.mark.parametrize("seed", [3, 202])
@pytest.mark.parametrize("explore", [False, True])
def test_sampled_world_served_like_reference(seed, explore):
    margins = []
    port = serve_world("repro_torch", seed, explore, margins)
    ref = serve_world("repro", seed, explore)
    comps, rcomps = port[0], ref[0]
    assert len(comps) == len(rcomps) > 0
    assert [comp_key(c) for c in comps] == [comp_key(c) for c in rcomps]
    assert max_logp_diff(comps, rcomps) <= LOGP_ATOL
    assert port[1:] == ref[1:]
    assert any(c.traj.actions for c in comps)
    assert margins and min(margins) > MIN_MARGIN
