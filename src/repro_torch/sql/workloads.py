"""Benchmark workloads: templated query generators (§VII-A4b).

Each template fixes a join graph; instantiation randomizes predicate
constants while preserving the join structure — exactly the paper's query
generation. JOB-like: 16 templates over the 21-table schema joining 4-17
relations. ExtJOB-like: 12 templates with *different join graphs* over the
same schema (snowflake chains and person-centric shapes). STACK-like: 12
templates over the 10-table schema joining 4-12 relations.

Train sets are generated from templates with a seeded RNG; test sets use a
disjoint seed range (JOB/ExtJOB test = the canonical instantiation per
template variant, STACK test = extra instantiations), mirroring §VII-A4b.
The partition is the repo-wide contract in `repro_torch.gen.seeds`: train draws
from `default_rng(train_seed(base))`, test from
`default_rng(test_seed(base))` = base + TRAIN_TEST_SEED_GAP, and
`make_workload` asserts the base seed sits inside one partitionable span
so no caller's train range can collide with another's test range.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np

from repro_torch.gen.seeds import split_train_test
from repro_torch.sql.query import Filter, JoinCond, Query, Relation


def _yr(rng, lo=1920, hi=2013, width=(3, 40)):
    a = int(rng.integers(lo, hi))
    w = int(rng.integers(*width))
    return Filter("production_year", ">=", (a - w,)), Filter("production_year", "<=", (a,))


def _in(rng, col, n_max, k=(1, 6)):
    kk = int(rng.integers(*k))
    vals = tuple(int(v) for v in rng.choice(n_max, size=min(kk, n_max), replace=False))
    return Filter(col, "in", vals)


# ------------------------------------------------------------------ JOB-like
def _job_templates() -> List[Tuple[str, Callable]]:
    """Each returns (relations, conds) given an rng. Aliases follow JOB
    conventions (t=title, mc=movie_companies, ci=cast_info, mi=movie_info,
    mk=movie_keyword, ...)."""
    T = []

    def base(rng, extra: Sequence[str], t_filters=True, fact_filters=()):
        rels = [Relation("t", "title",
                         tuple(_yr(rng)) if t_filters else ())]
        conds = []
        fk = {"mc": ("movie_companies", "movie_id"),
              "ci": ("cast_info", "movie_id"),
              "mi": ("movie_info", "movie_id"),
              "miidx": ("movie_info_idx", "movie_id"),
              "mk": ("movie_keyword", "movie_id"),
              "at": ("aka_title", "movie_id"),
              "cc": ("complete_cast", "movie_id"),
              "ml": ("movie_link", "movie_id")}
        dim = {"cn": ("company_name", "mc", "company_id", "id"),
               "ct": ("company_type", "mc", "company_type_id", "id"),
               "n": ("name", "ci", "person_id", "id"),
               "rt": ("role_type", "ci", "role_id", "id"),
               "chn": ("char_name", "ci", "person_id", "id"),
               "it": ("info_type", "mi", "info_type_id", "id"),
               "it2": ("info_type", "miidx", "info_type_id", "id"),
               "k": ("keyword", "mk", "keyword_id", "id"),
               "kt": ("kind_type", "t", "kind_id", "id"),
               "lt": ("link_type", "ml", "link_type_id", "id"),
               "cct": ("comp_cast_type", "cc", "subject_id", "id"),
               "an": ("aka_name", "n", "id", "person_id"),
               "pi": ("person_info", "n", "id", "person_id")}
        for a in extra:
            if a in fk:
                tab, col = fk[a]
                f = []
                if a == "mi":
                    f = [_in(rng, "info_type_id", 110, (1, 4))]
                if a == "mk" and rng.random() < 0.7:
                    f = [_in(rng, "keyword_id", 400, (1, 8))]
                if a == "ci" and rng.random() < 0.5:
                    f = [_in(rng, "role_id", 12, (1, 3))]
                rels.append(Relation(a, tab, tuple(f)))
                conds.append(JoinCond("t", "id", a, "movie_id"))
            else:
                tab, parent, pcol, mycol = dim[a]
                f = []
                if a == "cn":
                    f = [_in(rng, "country_code", 60, (1, 3))]
                if a == "n" and rng.random() < 0.5:
                    f = [Filter("gender", "==", (int(rng.integers(0, 3)),))]
                if a == "k":
                    f = [_in(rng, "id", 400, (1, 10))]
                rels.append(Relation(a, tab, tuple(f)))
                conds.append(JoinCond(parent, pcol, a, mycol))
        return tuple(rels), tuple(conds)

    T.append(("q1", lambda rng: base(rng, ["mc", "cn", "ct"])))                       # 4
    T.append(("q2", lambda rng: base(rng, ["mk", "k", "mc", "cn"])))                  # 5
    T.append(("q3", lambda rng: base(rng, ["mi", "it", "mk", "k"])))                  # 5
    T.append(("q4", lambda rng: base(rng, ["ci", "n", "rt", "mc"])))                  # 5
    T.append(("q5", lambda rng: base(rng, ["ci", "n", "mk", "k", "kt"])))             # 6
    T.append(("q6", lambda rng: base(rng, ["mc", "cn", "mi", "it", "mk", "k"])))      # 7
    T.append(("q7", lambda rng: base(rng, ["ci", "n", "an", "pi", "mc", "cn"])))      # 7
    T.append(("q8", lambda rng: base(rng, ["ci", "n", "rt", "mi", "it", "mk", "k"])))  # 8
    T.append(("q9", lambda rng: base(rng, ["mc", "cn", "ct", "mi", "miidx", "it", "it2"])))  # 8
    T.append(("q10", lambda rng: base(rng, ["ci", "n", "chn", "rt", "mc", "cn", "ct", "kt"])))  # 9
    T.append(("q11", lambda rng: base(rng, ["ml", "lt", "mk", "k", "mc", "cn", "mi", "it"])))   # 9
    T.append(("q12", lambda rng: base(rng, ["cc", "cct", "mk", "k", "mi", "it", "ci", "n", "kt"])))  # 10
    T.append(("q13", lambda rng: base(rng, ["ci", "n", "an", "pi", "mi", "it", "mk", "k", "mc", "cn", "ct"])))  # 12
    T.append(("q14", lambda rng: base(rng, ["ml", "lt", "cc", "cct", "mk", "k", "mi", "miidx", "it", "it2", "mc", "cn"])))  # 13
    T.append(("q15", lambda rng: base(rng, ["ci", "n", "chn", "rt", "an", "pi", "mi", "it", "mk", "k", "mc", "cn", "ct", "kt"])))  # 15
    T.append(("q16", lambda rng: base(rng, ["ml", "lt", "ci", "n", "rt", "an", "pi", "mi", "miidx", "it", "it2", "mk", "k", "mc", "cn", "ct"])))  # 17
    return T


# --------------------------------------------------------------- ExtJOB-like
def _extjob_templates() -> List[Tuple[str, Callable]]:
    """Different join graphs over the same schema: person-centric snowflakes
    and link-chains absent from the JOB-like set (the paper's ExtJOB has
    'entirely different join graphs and predicates')."""
    T = []

    def person_centric(rng, extra):
        """Root at `name`, hang the movie side off cast_info."""
        rels = [Relation("n", "name",
                         (Filter("gender", "==", (int(rng.integers(0, 3)),)),)),
                Relation("ci", "cast_info",
                         (_in(rng, "role_id", 12, (1, 4)),)),
                Relation("t", "title", tuple(_yr(rng)))]
        conds = [JoinCond("n", "id", "ci", "person_id"),
                 JoinCond("ci", "movie_id", "t", "id")]
        grow = {"pi": ("person_info", JoinCond("n", "id", "pi", "person_id"),
                       [_in(rng, "info_type_id", 40, (1, 4))]),
                "an": ("aka_name", JoinCond("n", "id", "an", "person_id"), []),
                "mk": ("movie_keyword", JoinCond("t", "id", "mk", "movie_id"),
                       [_in(rng, "keyword_id", 400, (1, 8))]),
                "k": ("keyword", JoinCond("mk", "keyword_id", "k", "id"), []),
                "mc": ("movie_companies", JoinCond("t", "id", "mc", "movie_id"), []),
                "cn": ("company_name", JoinCond("mc", "company_id", "cn", "id"),
                       [_in(rng, "country_code", 60, (1, 4))]),
                "mi": ("movie_info", JoinCond("t", "id", "mi", "movie_id"),
                       [_in(rng, "info_type_id", 110, (1, 4))]),
                "kt": ("kind_type", JoinCond("t", "kind_id", "kt", "id"), [])}
        for a in extra:
            tab, cond, f = grow[a]
            rels.append(Relation(a, tab, tuple(f)))
            conds.append(cond)
        return tuple(rels), tuple(conds)

    def link_chain(rng, extra):
        """movie_link chain: t -(ml)-> t2 with decorations."""
        rels = [Relation("t", "title", tuple(_yr(rng))),
                Relation("ml", "movie_link", ()),
                Relation("t2", "title", ()),
                Relation("lt", "link_type",
                         (_in(rng, "id", 18, (1, 4)),))]
        conds = [JoinCond("t", "id", "ml", "movie_id"),
                 JoinCond("ml", "linked_movie_id", "t2", "id"),
                 JoinCond("ml", "link_type_id", "lt", "id")]
        grow = {"mk2": ("movie_keyword", JoinCond("t2", "id", "mk2", "movie_id"),
                        [_in(rng, "keyword_id", 400, (1, 8))]),
                "mc": ("movie_companies", JoinCond("t", "id", "mc", "movie_id"), []),
                "cn": ("company_name", JoinCond("mc", "company_id", "cn", "id"),
                       [_in(rng, "country_code", 60, (1, 4))]),
                "mi2": ("movie_info", JoinCond("t2", "id", "mi2", "movie_id"),
                        [_in(rng, "info_type_id", 110, (1, 4))]),
                "ci2": ("cast_info", JoinCond("t2", "id", "ci2", "movie_id"), []),
                "n2": ("name", JoinCond("ci2", "person_id", "n2", "id"), [])}
        for a in extra:
            tab, cond, f = grow[a]
            rels.append(Relation(a, tab, tuple(f)))
            conds.append(cond)
        return tuple(rels), tuple(conds)

    T.append(("e1", lambda rng: person_centric(rng, [])))                      # 3
    T.append(("e2", lambda rng: person_centric(rng, ["pi"])))                  # 4
    T.append(("e3", lambda rng: person_centric(rng, ["an", "pi"])))            # 5
    T.append(("e4", lambda rng: person_centric(rng, ["mk", "k"])))             # 5
    T.append(("e5", lambda rng: person_centric(rng, ["mk", "k", "kt"])))       # 6
    T.append(("e6", lambda rng: person_centric(rng, ["mc", "cn", "mi"])))      # 6
    T.append(("e7", lambda rng: person_centric(rng, ["pi", "an", "mk", "k", "mc", "cn"])))  # 9
    T.append(("e8", lambda rng: link_chain(rng, [])))                          # 4
    T.append(("e9", lambda rng: link_chain(rng, ["mk2"])))                     # 5
    T.append(("e10", lambda rng: link_chain(rng, ["mc", "cn"])))               # 6
    T.append(("e11", lambda rng: link_chain(rng, ["mi2", "ci2", "n2"])))       # 7
    T.append(("e12", lambda rng: link_chain(rng, ["mk2", "mi2", "mc", "cn", "ci2", "n2"])))  # 10
    return T


# ---------------------------------------------------------------- STACK-like
def _stack_templates() -> List[Tuple[str, Callable]]:
    T = []

    def base(rng, extra):
        rels = [Relation("s", "site", (_in(rng, "id", 40, (1, 4)),)),
                Relation("q", "question",
                         (Filter("score", ">=", (int(rng.integers(0, 20)),)),)),
                Relation("tq", "tag_question", ()),
                Relation("tg", "tag", (_in(rng, "id", 600, (1, 10)),))]
        conds = [JoinCond("q", "site_id", "s", "id"),
                 JoinCond("tq", "question_id", "q", "id"),
                 JoinCond("tq", "tag_id", "tg", "id")]
        grow = {"a": ("answer", JoinCond("a", "question_id", "q", "id"), []),
                "u": ("so_user", JoinCond("q", "owner_user_id", "u", "id"),
                      [Filter("reputation", ">=", (int(rng.integers(0, 60)),))]),
                "u2": ("so_user", JoinCond("a", "owner_user_id", "u2", "id"), []),
                "acc": ("account", JoinCond("u", "account_id", "acc", "id"),
                        [_in(rng, "website_kind", 5, (1, 2))]),
                "b": ("badge", JoinCond("b", "user_id", "u", "id"),
                      [_in(rng, "badge_kind", 40, (1, 6))]),
                "c": ("comment", JoinCond("c", "post_id", "q", "id"), []),
                "pl": ("post_link", JoinCond("pl", "question_id", "q", "id"), []),
                "q2": ("question", JoinCond("pl", "related_question_id", "q2", "id"), [])}
        for a in extra:
            tab, cond, f = grow[a]
            rels.append(Relation(a, tab, tuple(f)))
            conds.append(cond)
        return tuple(rels), tuple(conds)

    T.append(("s1", lambda rng: base(rng, [])))                                # 4
    T.append(("s2", lambda rng: base(rng, ["a"])))                             # 5
    T.append(("s3", lambda rng: base(rng, ["u"])))                             # 5
    T.append(("s4", lambda rng: base(rng, ["u", "acc"])))                      # 6
    T.append(("s5", lambda rng: base(rng, ["a", "u2"])))                       # 6
    T.append(("s6", lambda rng: base(rng, ["u", "b"])))                        # 6
    T.append(("s7", lambda rng: base(rng, ["c"])))                             # 5
    T.append(("s8", lambda rng: base(rng, ["pl", "q2"])))                      # 6
    T.append(("s9", lambda rng: base(rng, ["a", "u", "acc"])))                 # 7
    T.append(("s10", lambda rng: base(rng, ["a", "u2", "c", "pl", "q2"])))     # 9
    T.append(("s11", lambda rng: base(rng, ["u", "acc", "b", "a", "u2"])))     # 9
    T.append(("s12", lambda rng: base(rng, ["a", "u", "u2", "acc", "b", "c", "pl", "q2"])))  # 12
    return T


def shuffle_relations(rels, conds, rng) -> Tuple:
    """Randomize the FROM-clause order (real SQL authors don't order joins
    for the executor; Spark's no-CBO path executes the text order, which is
    what makes the paper's Spark-default baseline fail on 9-30% of queries).
    The first relation is kept with prob 0.5 so some queries stay easy."""
    rels = list(rels)
    if rng.random() < 0.5:
        head, tail = rels[:1], rels[1:]
        rng.shuffle(tail)
        rels = head + tail
    else:
        rng.shuffle(rels)
    return tuple(rels), conds


@dataclasses.dataclass
class Workload:
    name: str
    max_tables: int
    train: List[Query]
    test: List[Query]


_BENCH = {"job": _job_templates, "extjob": _extjob_templates,
          "stack": _stack_templates}


def query_stream(bench: str, seed: int = 0):
    """Endless generator of fresh template instantiations (round-robin over
    the benchmark's templates) — the unbounded query source the online
    serving driver (`serve.driver`) feeds from."""
    templates = _BENCH[bench]()
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        tname, fn = templates[i % len(templates)]
        rels, conds = shuffle_relations(*fn(rng), rng)
        yield Query(f"{bench}/{tname}#st{i}", rels, conds)
        i += 1


def make_workload(bench: str, n_train: int = 200, n_test_per_template: int = 2,
                  seed: int = 7) -> Workload:
    """Train/test instantiations of `bench`'s templates. `seed` is a BASE
    seed under the `repro_torch.gen.seeds` partition: train constants come from
    the train stream, test constants from the disjoint test stream
    (asserted partitionable — the streams provably never overlap)."""
    templates = _BENCH[bench]()
    train_s, test_s = split_train_test(seed)
    train: List[Query] = []
    rng = np.random.default_rng(train_s)
    i = 0
    while len(train) < n_train:
        tname, fn = templates[i % len(templates)]
        rels, conds = shuffle_relations(*fn(rng), rng)
        train.append(Query(f"{bench}/{tname}#tr{len(train)}", rels, conds))
        i += 1
    test: List[Query] = []
    rng_t = np.random.default_rng(test_s)
    for tname, fn in templates:
        for j in range(n_test_per_template):
            rels, conds = shuffle_relations(*fn(rng_t), rng_t)
            test.append(Query(f"{bench}/{tname}#{j}", rels, conds))
    mt = max(q.n_relations for q in train + test)
    return Workload(bench, mt, train, test)
