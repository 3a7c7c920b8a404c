"""Deterministic, shardable, resumable LM data pipeline.

Properties a 1000-node deployment needs, all present here:

  * Determinism: batch(step, shard) is a pure function of (seed, step,
    shard) — recomputable anywhere, so a restarted/migrated host produces
    byte-identical data with no coordination.
  * Elastic resharding: shards are logical (n_logical >> n_hosts); a host
    owns a contiguous range, so pods joining/leaving only remaps ranges
    (runtime/elastic.py) without touching the stream contents.
  * Resumability: DataState is just (step,), checkpointed with the model.
  * Prefetch: a background thread keeps `depth` batches ready so host
    data work overlaps device compute.

The token source is a synthetic Zipf-distributed stream with document
structure (BOS-delimited docs, packed to seq_len) — the statistical shape
a real tokenized corpus has where it matters for throughput testing.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class SyntheticLMPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_logical_shards: int = 256,
                 shard_range=(0, 256), mean_doc_len: int = 512,
                 prefetch_depth: int = 2):
        assert global_batch % n_logical_shards == 0 or \
            n_logical_shards % global_batch == 0 or True
        self.vocab = vocab_size
        self.seq = seq_len
        self.gb = global_batch
        self.seed = seed
        self.n_logical = n_logical_shards
        self.shard_range = shard_range
        self.mean_doc = mean_doc_len
        self.state = DataState()
        self._q: Optional[queue.Queue] = None
        self._depth = prefetch_depth
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------------------------------------- core
    def _shard_rows(self) -> int:
        lo, hi = self.shard_range
        frac = (hi - lo) / self.n_logical
        rows = int(round(self.gb * frac))
        return rows

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, shard_range): the host's slice of
        the global batch for `step`."""
        lo, hi = self.shard_range
        rows_per_shard = max(1, self.gb // self.n_logical)
        toks = []
        for shard in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, shard]))
            t = self._pack(rng, rows_per_shard)
            toks.append(t)
        tokens = np.concatenate(toks, axis=0)
        mask = (tokens != 0).astype(np.float32)
        return {"tokens": tokens, "loss_mask": mask}

    def _pack(self, rng, rows: int) -> np.ndarray:
        """BOS-delimited Zipf docs packed into rows of seq_len."""
        out = np.empty((rows, self.seq), np.int32)
        for r in range(rows):
            pos = 0
            row = np.empty(self.seq, np.int32)
            while pos < self.seq:
                dl = min(int(rng.exponential(self.mean_doc)) + 8,
                         self.seq - pos)
                row[pos] = 1                                   # BOS
                body = rng.zipf(1.3, size=dl - 1)
                row[pos + 1:pos + dl] = np.clip(body + 1, 2, self.vocab - 1)
                pos += dl
            out[r] = row
        return out

    # ----------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._q is not None:
            b = self._q.get()
        else:
            b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # ----------------------------------------------------------- prefetch
    def start_prefetch(self):
        self._q = queue.Queue(maxsize=self._depth)
        self._stop.clear()
        start = self.state.step

        def worker():
            s = start
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop_prefetch(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._q = None

    # ----------------------------------------------------------- elastic
    def reshard(self, shard_range) -> "SyntheticLMPipeline":
        """New pipeline serving a different logical-shard range at the SAME
        step (used on pod loss/join)."""
        p = SyntheticLMPipeline(
            vocab_size=self.vocab, seq_len=self.seq, global_batch=self.gb,
            seed=self.seed, n_logical_shards=self.n_logical,
            shard_range=shard_range, mean_doc_len=self.mean_doc,
            prefetch_depth=self._depth)
        p.state = DataState(self.state.step)
        return p
