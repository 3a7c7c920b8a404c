"""Seed bookkeeping: the disjoint train/test partition and sub-stream
derivation every sampler in `repro_torch.gen` (and `sql.workloads`) shares.

The contract: one base seed names a workload; the TRAIN RNG stream is
`default_rng(train_seed(base))`, the TEST stream
`default_rng(test_seed(base))`, and the two are guaranteed disjoint —
no query instantiation is ever drawn from both, so a policy evaluated on
the test split has provably never trained on those constants. The
partition is a fixed offset of `TRAIN_TEST_SEED_GAP`; callers that sweep
base seeds must stay inside one span (`assert_partitionable` checks),
otherwise one sweep's train range would collide with another's test
range.

`substream` derives independent child seeds for the world sampler's
layered stages (schema vs data vs queries vs stream) from one world
seed: a splitmix-style integer hash, so neighbouring world seeds do not
produce overlapping numpy streams the way raw `seed + k` offsets would.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["TRAIN_TEST_SEED_GAP", "train_seed", "test_seed",
           "split_train_test", "seed_ranges", "assert_partitionable",
           "substream"]

# One span of base seeds maps onto [base, base+GAP) for train and
# [base+GAP, base+2*GAP) for test. 10_000 is load-bearing: it is the
# offset `sql.workloads.make_workload` has used since the seed, so
# every pinned workload stays bit-identical.
TRAIN_TEST_SEED_GAP = 10_000


def train_seed(base: int) -> int:
    return base


def test_seed(base: int) -> int:
    return base + TRAIN_TEST_SEED_GAP


def split_train_test(base: int) -> Tuple[int, int]:
    """(train_seed, test_seed) for one workload base seed."""
    assert_partitionable(base)
    return train_seed(base), test_seed(base)


def seed_ranges(base0: int = 0) -> Tuple[range, range]:
    """The disjoint (train, test) seed ranges for bases in
    [base0, base0 + GAP)."""
    return (range(base0, base0 + TRAIN_TEST_SEED_GAP),
            range(base0 + TRAIN_TEST_SEED_GAP,
                  base0 + 2 * TRAIN_TEST_SEED_GAP))


def assert_partitionable(base: int, base0: int = 0) -> None:
    """`base` must sit inside one span so its train range cannot reach
    into any test range."""
    assert base0 <= base < base0 + TRAIN_TEST_SEED_GAP, \
        f"base seed {base} outside the partitionable span " \
        f"[{base0}, {base0 + TRAIN_TEST_SEED_GAP}): its train/test " \
        f"ranges would collide with a neighbouring span's"


def substream(seed: int, stage: int) -> int:
    """Deterministic child seed for sampler `stage` of world `seed` —
    a splitmix64 round, truncated to numpy's int seed range."""
    z = (seed * 0x9E3779B97F4A7C15 + stage * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return int((z ^ (z >> 31)) % (1 << 31))
