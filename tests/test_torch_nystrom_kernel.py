"""The port's fused Nystrom attention (ops/nystrom_kernel.py) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

On the CPU the port's wrappers take their plain versions, so these hold the
plain versions B3-B6 and the analytic backward to the Pallas kernels and
their custom VJPs. Shapes are tiny (2 heads of 16, 16 landmarks, n = 80 with
block 64, so the last block is ragged). Tolerances: 2e-4 for the forward,
as tests/test_pallas_nystrom.py holds the Pallas kernels, and 1e-4 for the
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from transmil_deepgraft_tpu.ops.pallas import nystrom_kernel as jnk
from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as tnk
from transmil_deepgraft_tpu_torch.ops.nystrom import nystrom_attention

B, H, D, M, N, BLOCK = 2, 2, 16, 16, 80, 64
FWD_TOL, GRAD_TOL = 2e-4, 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread keeps them cheap on a loaded CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kernel", ["landmark", "query"])
def test_bh_layout_kernels_match_pallas(kernel):
    """B3 landmark_attention and B4 query_landmark_attention, (bh, n, d)."""
    bh = B * H
    if kernel == "landmark":
        q_lm, k, v = _arrays((bh, M, D), (bh, N, D), (bh, N, D))
        want = jnk.landmark_attention(jnp.asarray(q_lm), jnp.asarray(k), jnp.asarray(v),
                                      block_n=BLOCK)
        got = tnk.landmark_attention(_t(q_lm), _t(k), _t(v), block_n=BLOCK)
    else:
        q, k_lm, bm = _arrays((bh, N, D), (bh, M, D), (bh, M, D))
        want = jnk.query_landmark_attention(jnp.asarray(q), jnp.asarray(k_lm), jnp.asarray(bm),
                                            block_n=BLOCK)
        got = tnk.query_landmark_attention(_t(q), _t(k_lm), _t(bm), block_n=BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_fused_packed_matches_pallas_forward_and_vjp(scale):
    """nystrom_attention_fused_packed (B5 + B6) and its backward, against
    JAX's custom VJP (_packed_bwd with its scale fold)."""
    qkv, g = _arrays((B, N, 3, H, D), (B, N, H, D), seed=1)
    want, vjp = jax.vjp(
        lambda x: jnk.nystrom_attention_fused_packed(x, M, 6, BLOCK, scale), jnp.asarray(qkv))
    (want_grad,) = vjp(jnp.asarray(g))

    x = _t(qkv).requires_grad_(True)
    got = tnk.nystrom_attention_fused_packed(x, M, 6, BLOCK, scale)
    got.backward(_t(g))
    assert got.shape == (B, N, H, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=GRAD_TOL, rtol=0)


def test_fused_bh_layout_matches_pallas_forward_and_vjp():
    """nystrom_attention_fused (B3 + B4, (b, h, n, d)) and its backward."""
    q, k, v, g = _arrays(*[(B, H, N, D)] * 4, seed=2)
    want, vjp = jax.vjp(lambda a, b, c: jnk.nystrom_attention_fused(a, b, c, M, 6, BLOCK),
                        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))

    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    got = tnk.nystrom_attention_fused(*ts, M, 6, BLOCK)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)


def test_analytic_backward_matches_jax_and_torch_autograd():
    """nystrom_attention_bwd against JAX's, and against torch autograd
    through the port's plain op."""
    q, k, v, g = _arrays(*[(B, H, N, D)] * 4, seed=3)
    got = tnk.nystrom_attention_bwd(_t(q), _t(k), _t(v), _t(g), num_landmarks=M,
                                    pinv_iterations=6)
    want = jnk.nystrom_attention_bwd(*map(jnp.asarray, (q, k, v, g)), num_landmarks=M,
                                     pinv_iterations=6)
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    nystrom_attention(*ts, num_landmarks=M, pinv_iterations=6).out.backward(_t(g))
    for a, w, t in zip(got, want, ts):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=GRAD_TOL, rtol=0)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors."""
    q_lm, k, v = (torch.zeros(1, M, D, device="meta"), torch.zeros(1, N, D, device="meta"),
                  torch.zeros(1, N, D, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tnk.landmark_attention(q_lm, k, v)
