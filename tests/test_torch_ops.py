"""The port's ops against their JAX counterparts on the same numpy inputs
(padding, Newton-Schulz pinv, Nystrom attention, depthwise convs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.ops import depthwise as jdw
from transmil_deepgraft_tpu.ops import nystrom as jny
from transmil_deepgraft_tpu.ops import padding as jpad
from transmil_deepgraft_tpu.ops.pinv import newton_schulz_pinv as jax_pinv
from transmil_deepgraft_tpu_torch.ops import depthwise as tdw
from transmil_deepgraft_tpu_torch.ops import nystrom as tny
from transmil_deepgraft_tpu_torch.ops import padding as tpad
from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz_pinv as torch_pinv

TOL = 5e-4  # float32, different summation orders on both sides


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers on the
    machine's cores, and the port's plain paths are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_buckets_match_jax():
    assert tpad.DEFAULT_BUCKETS == jpad.DEFAULT_BUCKETS


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4000, 65536, 70000])
def test_bucket_for_length_matches_jax(n):
    assert tpad.bucket_for_length(n) == jpad.bucket_for_length(n)


@pytest.mark.parametrize("n", [1, 2, 17, 237, 256, 40960])
def test_square_pad_length_matches_jax(n):
    assert tpad.square_pad_length(n) == jpad.square_pad_length(n)


@pytest.mark.parametrize("n", [9, 10, 30])
def test_duplicate_pad_square_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((2, n, 5)).astype(np.float32)
    got, gh, gw = tpad.duplicate_pad_square(_t(x))
    want, wh, ww = jpad.duplicate_pad_square(jnp.asarray(x))
    assert (gh, gw) == (wh, ww)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [16, 30, 33])
def test_pad_to_landmark_multiple_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((1, 2, n, 4)).astype(np.float32)
    got, gpad = tny.pad_to_landmark_multiple(_t(x), 16)
    want, wpad = jny.pad_to_landmark_multiple(jnp.asarray(x), 16)
    assert gpad == wpad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_means_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 48, 8)).astype(np.float32)
    _close(tny._segment_means(_t(x), 16), jny._segment_means(jnp.asarray(x), 16), 1e-6)


@pytest.mark.parametrize("shape,iters", [((2, 3, 16, 16), 6), ((1, 8, 32, 32), 6), ((4, 16, 16), 3)])
def test_pinv_matches_jax(shape, iters):
    logits = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    a = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)  # row-stochastic, as in attention
    _close(torch_pinv(_t(a), iters), jax_pinv(jnp.asarray(a), iters))


def test_pinv_init_divisor_is_one_global_max():
    """Scaling one batch entry changes the others' result: the init divisor
    is a single max over every batch/head, kept from the reference."""
    a = np.abs(np.random.default_rng(2).standard_normal((2, 8, 8))).astype(np.float32)
    alone = torch_pinv(_t(a[:1]), 1)
    b = a.copy()
    b[1] *= 10
    together = torch_pinv(_t(b), 1)
    assert not torch.allclose(alone[0], together[0])


def _qkv(seed, b=1, h=2, n=64, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("row_index", [None, 0, 5])
@pytest.mark.parametrize("n,m", [(64, 16), (96, 32)])
def test_nystrom_attention_matches_jax(n, m, row_index):
    q, k, v = _qkv(n + m, n=n)
    got = tny.nystrom_attention(_t(q), _t(k), _t(v), num_landmarks=m,
                                return_row_index=row_index)
    want = jny.nystrom_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 num_landmarks=m, return_row_index=row_index)
    _close(got.out, want.out)
    if row_index is None:
        assert got.cls_row is None and want.cls_row is None
    else:
        _close(got.cls_row, want.cls_row)


def test_nystrom_attention_rejects_unpadded_length():
    q, k, v = _qkv(0, n=60)
    with pytest.raises(ValueError):
        tny.nystrom_attention(_t(q), _t(k), _t(v), num_landmarks=16)


@pytest.mark.parametrize("row_index", [0, 17])
def test_nystrom_attention_row_matches_jax(row_index):
    q, k, _ = _qkv(3, n=64)
    got = tny.nystrom_attention_row(_t(q), _t(k), num_landmarks=16, row_index=row_index)
    want = jny.nystrom_attention_row(jnp.asarray(q), jnp.asarray(k), num_landmarks=16,
                                     row_index=row_index)
    _close(got, want)
    # and it is the row nystrom_attention returns
    full = tny.nystrom_attention(_t(q), _t(k), _t(q), num_landmarks=16, return_row_index=row_index)
    _close(got, full.cls_row)


@pytest.mark.parametrize("k", [3, 33])
def test_depthwise_conv1d_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    w = rng.standard_normal((k, 1, 6)).astype(np.float32)
    _close(tdw.depthwise_conv1d(_t(x), _t(w)), jdw.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w)), 1e-5)


@pytest.mark.parametrize("kh,kw", [(3, 3), (7, 7), (5, 3)])
def test_depthwise_conv2d_matches_jax(kh, kw):
    rng = np.random.default_rng(kh * 10 + kw)
    x = rng.standard_normal((2, 9, 8, 4)).astype(np.float32)
    w = rng.standard_normal((kh, kw, 1, 4)).astype(np.float32)
    _close(tdw.depthwise_conv2d(_t(x), _t(w)), jdw.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w)), 1e-5)
