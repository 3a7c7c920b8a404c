"""The `train_tokens` traffic: the token batches of a training job, one a
step, drawn from the run's seed.

Each row is BOS-delimited documents of Zipf-distributed token ids packed
to the sequence length: a document's length is exponential about
`mean_doc_len` plus 8, its first id 1 (BOS), its others Zipf(`zipf_a`) + 1
clipped to [2, vocab - 1]. Row r of step s draws from
numpy's `default_rng(SeedSequence([seed, s, r]))`, so a step's batch is a
pure function of (seed, step) and every row of every step differs. The
loss mask is 1 where the id is not 0: everywhere.

A frozen copy of the draw of the program's
`data.pipeline.SyntheticLMPipeline` at `n_logical_shards = batch` over
shards [0, batch), one row a shard; the benchmark's tests hold the two
equal.

Parameters (the traffic file): batch, seq, mean_doc_len, zipf_a.
"""
from __future__ import annotations

import numpy as np


def entropy(seed: int) -> int:
    """A seed as numpy's SeedSequence takes it: a whole number >= 0."""
    return int(seed) % (1 << 64)


def row(rng, seq: int, vocab: int, mean_doc_len: int, zipf_a: float):
    out = np.empty(seq, np.int32)
    pos = 0
    while pos < seq:
        dl = min(int(rng.exponential(mean_doc_len)) + 8, seq - pos)
        out[pos] = 1                                           # BOS
        body = rng.zipf(zipf_a, size=dl - 1)
        out[pos + 1:pos + dl] = np.clip(body + 1, 2, vocab - 1)
        pos += dl
    return out


def batch(traffic: dict, vocab: int, seed: int, step: int) -> dict:
    """Step `step`'s batch: {"tokens": int32 (B, S), "loss_mask": float32
    (B, S)}."""
    rows = [row(np.random.default_rng(np.random.SeedSequence(
        [entropy(seed), step, r])), traffic["seq"], vocab,
        traffic["mean_doc_len"], traffic["zipf_a"])
        for r in range(traffic["batch"])]
    tokens = np.stack(rows)
    return {"tokens": tokens, "loss_mask": (tokens != 0).astype(np.float32)}


def tokens_per_step(traffic: dict) -> int:
    return traffic["batch"] * traffic["seq"]
