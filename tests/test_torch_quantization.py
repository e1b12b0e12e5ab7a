"""The port's int8 quantization primitives against ``ops/quantization.py`` of
the JAX package on the same seeded numpy inputs: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.ops import quantization as jq
from transmil_deepgraft_tpu_torch.ops import quantization as pq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers on the
    machine's cores, and the port's plain paths are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(1, 1, 64, 256), (3, 3, 32, 48), (4, 4, 12, 64)])
def test_build_time_primitives_bit_exact(shape):
    rng = np.random.default_rng(sum(shape))
    kernel = rng.standard_normal(shape)
    c = shape[-1]
    bn = (1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
          0.05 * rng.standard_normal(c), 1 + 0.1 * rng.random(c))
    for got, want in zip(pq.fold_bn(kernel, *bn), jq.fold_bn(kernel, *bn)):
        np.testing.assert_array_equal(got, want)
    k32 = kernel.astype(np.float32)
    (gw, gs), (jw, js) = pq.quantize_weight(k32), jq.quantize_weight(k32)
    np.testing.assert_array_equal(gw, jw)
    np.testing.assert_array_equal(gs, js)
    np.testing.assert_array_equal(pq.zero_point_bias(gw, 0.0123, gs),
                                  jq.zero_point_bias(jw, 0.0123, js))


def test_activation_quantizers_bit_exact():
    """Random values plus exact half-way points (round half to even in both)."""
    rng = np.random.default_rng(0)
    scale = np.float32(0.037)
    x = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32) * 3,
        (np.arange(-300, 300, dtype=np.float32) + 0.5) * scale,
        np.abs(rng.standard_normal(10_000)).astype(np.float32) * 10,
    ])
    np.testing.assert_array_equal(
        pq.quantize_act(torch.from_numpy(x), float(scale)).numpy(),
        np.asarray(jq.quantize_act(jnp.asarray(x), scale)))
    np.testing.assert_array_equal(
        pq.quantize_act_relu(torch.from_numpy(x), float(scale)).numpy(),
        np.asarray(jq.quantize_act_relu(jnp.asarray(x), scale)))
