"""The traffic generator (the same traffic from the same seed; every seed the
same work in another order) and the cost functions against hand counts."""

from __future__ import annotations

import math

import numpy as np
import pytest

from portbench import costs, generator

SIZES = {"dist": "loguniform", "low": 512, "high": 40960, "count": 32}
SEEDS = [0, 7, 2 ** 31 + 5, 3 * 2 ** 31 + 17]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_same_seed_gives_the_same_traffic(seed):
    assert generator.sizes(SIZES, seed, 100) == generator.sizes(SIZES, seed, 100)
    lengths = generator.sizes(SIZES, seed, 100)
    offsets = generator.offsets_into(40960, lengths, seed)
    assert offsets == generator.offsets_into(40960, lengths, seed)
    assert generator.sample(100, seed, 8, keep=(3,)) == generator.sample(100, seed, 8, keep=(3,))


def test_every_seed_gets_the_same_work_block_by_block_in_another_order():
    a, b = generator.sizes(SIZES, 1, 96), generator.sizes(SIZES, 2, 96)
    for blk in (slice(0, 32), slice(32, 64), slice(64, 96)):
        assert sorted(a[blk]) == sorted(b[blk]) == sorted(a[:32]) and a[blk] != b[blk]
    assert a[:32] != a[32:64]  # each block its own order
    assert min(a) >= 512 and max(a) <= 40960
    # log-uniform quantiles: the geometric mean sits at sqrt(512 * 40960)
    assert abs(np.exp(np.mean(np.log(a[:32]))) / math.sqrt(512 * 40960) - 1) < 0.01


def test_offsets_and_samples_stay_in_range():
    lengths = generator.sizes(SIZES, 9, 64)
    for n, off in zip(lengths, generator.offsets_into(40960, lengths, 9)):
        assert 0 <= off and off + n <= 40960
    picked = generator.sample(50, 9, 8, keep=(49,))
    assert picked[0] == 49 and len(set(picked)) == 8 and max(picked) < 50


def test_resnet50_counts_4_09_gmac_a_tile_at_224():
    assert costs.r50_tile_ops(224) / 2 == pytest.approx(4.0871e9, rel=1e-4)
    # stage 1 on one 56 x 56 tile: three bottlenecks, the first with its
    # 64 -> 256 downsample (hand count)
    hw = 56 * 56
    macs = hw * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) \
        + 2 * hw * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    name, blocks, x = next(costs.r50_segments(224))
    assert name == "s1" and costs.r50_segment_cost(blocks, x, 1)[0] == 2 * macs


def test_qstage_bound_matches_the_kernel_tables_b7_and_b8_rows():
    """B7 0.369 ms and B8 0.145 ms on a 128-tile chunk (the smoke run's
    bound, operations at 1,979 TOP/s)."""
    assert costs.qstage_least_s(128) * 1e3 == pytest.approx(0.369 + 0.145, abs=0.002)


def test_landmark_and_translayer_kernel_counts_are_the_smoke_runs():
    """The chip smoke's nystrom_costs and kernel_costs, by hand."""
    b, n, h, d, m = 64, 256, 8, 64, 256
    ops, nbytes = costs.nystrom_kernel_costs(b, n)["landmark"]
    assert ops == 4 * m * n * h * d * b
    assert nbytes == 2 * b * h * m * d * 4 + 2 * b * n * h * d * 4
    t, pad, dim = 65537, 255, 512
    k1, k2 = (costs.translayer_kernel_costs(t)[k] for k in ("k1", "k2"))
    assert k1[0] == 2 * t * dim * 2 * dim + 2 * 2 * m * (t + pad) * dim
    assert k2[0] == 2 * t * dim * dim * 2 + 2 * 2 * m * t * dim
    act, w, lm, vec = t * dim * 4, dim * dim * 4, m * dim * 4, dim * 4
    assert k1[1] == act + 2 * vec + 2 * w + 2 * lm + act
    assert k2[1] == 2 * act + 3 * vec + 2 * w + 2 * lm + act


def test_transmil_tokens_and_the_peak_rule():
    assert costs.transmil_tokens(200) == (226, 256)  # 15^2 + cls, one landmark multiple
    assert costs.transmil_tokens(40960) == (203 ** 2 + 1, 161 * 256)
    assert costs.least_s(989e12, 0) == pytest.approx(1.0)
    assert costs.least_s(1979e12, 0, int8=True) == pytest.approx(1.0)
    assert costs.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert costs.ops_s(1979e12, 989e12) == pytest.approx(2.0)
    # a bigger bag costs more, and the forward's fc1 dominates at 200 rows
    assert costs.transmil_ops(400) > costs.transmil_ops(200) > 2 * 200 * (2048 * 1024 + 1024 * 512)
