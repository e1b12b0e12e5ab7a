"""The port's fused Nystrom attention (ops/nystrom_kernel.py) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

On the CPU the port's wrappers take their plain versions, so these hold the
plain versions B3-B6 and the analytic backward to the Pallas kernels and
their custom VJPs. Shapes are tiny (2 heads of 16, 16 landmarks, n = 80 with
block 64, so the last block is ragged). Tolerances: 2e-4 for the forward,
as tests/test_pallas_nystrom.py holds the Pallas kernels, and 1e-4 for the
gradients. Two more pin what the CUDA kernels take from Python: the grid
plans (every key and row covered once), and the 3xTF32 split's arithmetic,
emulated in torch at the training shape.
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


@pytest.fixture(autouse=True, scope="module")
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
        got = tnk.landmark_attention(_t(q_lm), _t(k), _t(v))
    else:
        q, k_lm, bm = _arrays((bh, N, D), (bh, M, D), (bh, M, D))
        want = jnk.query_landmark_attention(jnp.asarray(q), jnp.asarray(k_lm), jnp.asarray(bm),
                                            block_n=BLOCK)
        got = tnk.query_landmark_attention(_t(q), _t(k_lm), _t(bm))
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
    got = tnk.nystrom_attention_fused_packed(x, M, 6, scale)
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
    got = tnk.nystrom_attention_fused(*ts, M, 6)
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


@pytest.mark.parametrize("bh,n", [(16, 1280), (8, 41472), (16, 1000), (1, 1), (3, 64), (8, 65),
                                  (1, 100_000), (8, 65792), (16, 3256)])
def test_grid_plans_cover_every_key_and_row_once(bh, n):
    """The wrappers' grid plans, read as csrc/nystrom.cu reads them: the
    landmark kernel's splits take every 64-key tile once and none is empty
    (also at the 40,960-tile request's layer, b 8 x n 65,792, and at b 2,
    n 3,000); the query kernel's blocks take every 128-row tile of every
    head once. On 132 SMs the training shape (b 2 x 8 heads, n = 1,280)
    and a 40,960-tile bag (b 1, n = 41,472) give the grids the source's
    note states."""
    sms = 132
    per, splits = tnk.landmark_plan(bh, n, sms)
    tiles = -(-n // tnk.KEY_TILE)
    assert per >= 1 and splits >= 1
    covered = [t for s in range(splits) for t in range(s * per, min((s + 1) * per, tiles))]
    assert covered == list(range(tiles))
    assert all(s * per < tiles for s in range(splits))  # no split without keys

    blocks = tnk.query_plan(bh, n, sms)
    total = bh * -(-n // tnk.QUERY_ROWS)
    assert 1 <= blocks <= sms
    ranges = [range(total * i // blocks, total * (i + 1) // blocks) for i in range(blocks)]
    assert [t for r in ranges for t in r] == list(range(total))
    assert all(len(r) >= 1 for r in ranges)

    # (landmark grid blocks, keys a split, query blocks, query tiles)
    stated = {(16, 1280): (256, 320, 132, 160), (8, 41472): (256, 5184, 132, 2592)}
    if (bh, n) in stated:
        lm_rows = tnk.KERNEL_LANDMARKS // tnk.LANDMARK_ROWS
        assert (lm_rows * splits * bh, per * tnk.KEY_TILE, blocks, total) == stated[(bh, n)]


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x cut to TF32 (its top 19 bits), as the tensor core reads a float32."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32, ties away from zero (cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 as csrc/nystrom.cu does it: hi = x cut to TF32, lo the
    rest (cut again by the tensor core), lo*hi + hi*lo + hi*hi in float32.
    Products of two TF32 values are exact in float32."""
    ah, bh = _tf32_cut(a), _tf32_cut(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _query_attention_case(rng):
    """B6's arithmetic at the training shape (b 2 x 8 heads of 64, n = 1,280,
    256 landmarks; chip_smoke's input scales): (plain, split, one-pass)."""
    bh, n, d, m = 16, 1280, 64, 256
    q = torch.from_numpy(rng.standard_normal((bh, n, d), dtype=np.float32))
    k_lm = torch.from_numpy(0.125 * rng.standard_normal((bh, m, d), dtype=np.float32))
    bmat = torch.from_numpy(rng.standard_normal((bh, m, d), dtype=np.float32))
    want = tnk.query_landmark_attention_reference(q, k_lm, bmat)
    split = _split_matmul(torch.softmax(_split_matmul(q, k_lm.transpose(1, 2)), -1), bmat)
    p1 = torch.softmax(_tf32_round(q) @ _tf32_round(k_lm).transpose(1, 2), -1)
    return want, split, _tf32_round(p1) @ _tf32_round(bmat)


def _projection_case(rng):
    """A TransLayer projection (csrc/translayer.cu): 256 LayerNormed rows
    times a (1024, 512) fan-in-scaled weight, 512 deep: (plain, split,
    one-pass)."""
    x = torch.from_numpy(rng.standard_normal((256, 512), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((1024, 512)) / np.sqrt(512)).astype(np.float32))
    return x @ w.t(), _split_matmul(x, w.t()), _tf32_round(x) @ _tf32_round(w).t()


@pytest.mark.parametrize("case", [_query_attention_case, _projection_case],
                         ids=["query_attention", "projection"])
def test_split_tf32_holds_float32_where_one_pass_tf32_does_not(case):
    """Why the kernels take the 3xTF32 split: their arithmetic emulated in
    plain torch. With every product split the result is within 1e-5 of the
    float32 plain version; in one-pass TF32 (operands rounded to TF32) it is
    off by more than the kernels' 1e-4 bar."""
    want, split, one_pass = case(np.random.default_rng(7))
    assert (split - want).abs().max().item() <= 1e-5
    assert (one_pass - want).abs().max().item() > 1e-4
