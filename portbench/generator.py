"""The one traffic generator: turns a traffic file's parameters and a seed
into the sizes a runner sends.

Every seed gets the same multiset of sizes, in another order: sizes are the
``count`` quantiles of their distribution, sent in blocks of ``count``, each
block a fresh permutation drawn from its own stream of the seed. So two
seeds offer the same work block by block, and a window of many blocks
averages over many orders instead of repeating one.

Size specs: ``{"dist": "loguniform", "low", "high", "count"}``, log-uniform
quantiles.
"""

from __future__ import annotations

import numpy as np


def stream(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed (any whole number)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *tags])


def sizes(spec: dict, seed: int, items: int) -> list[int]:
    """The sizes of the first ``items`` items: ``spec``'s multiset in blocks,
    block b permuted by the stream (seed, 1, b)."""
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    count, lo, hi = int(spec["count"]), float(spec["low"]), float(spec["high"])
    q = (np.arange(count) + 0.5) / count
    values = np.rint(lo * (hi / lo) ** q).astype(np.int64)
    blocks = [stream(seed, 1, b).permutation(values) for b in range(-(-items // count))]
    return [int(v) for v in np.concatenate(blocks)[:items]]


def offsets_into(pool: int, lengths: list[int], seed: int) -> list[int]:
    """A start row in a pool of ``pool`` rows for each item of ``lengths``
    (each item a contiguous view of the pool)."""
    rng = stream(seed, 3)
    return [int(rng.integers(0, pool - n + 1)) for n in lengths]


def sample(count: int, seed: int, k: int, keep: tuple = ()) -> list[int]:
    """``k`` indices of ``count`` items drawn from the seed, those in
    ``keep`` first."""
    rest = [i for i in stream(seed, 4).permutation(count).tolist() if i not in keep]
    return list(dict.fromkeys(keep))[:k] + rest[:max(0, k - len(keep))]

