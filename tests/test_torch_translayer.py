"""The port's fused TransLayer (glue + the plain versions of its two CUDA
kernels on the CPU) against the JAX package's TransLayer.

The port follows the XLA path's front padding (zeros AFTER LayerNorm), so it
is held to that path with a front pad and a non-zero LayerNorm bias, and to
JAX's Pallas ``fused_translayer`` (interpret mode) where no pad is needed.
One more runs the card path's staging (the padded K/V buffers, the strides
handed to the landmark kernels, the V view, O + res) at full width with plain
stand-ins for its launches.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from transmil_deepgraft_tpu.models.layers import NystromAttentionLayer as JaxNystromLayer
from transmil_deepgraft_tpu.ops.pallas.translayer_kernel import fused_translayer as jax_fused
from transmil_deepgraft_tpu_torch.models.layers import NystromAttentionLayer
from transmil_deepgraft_tpu_torch.ops import nystrom_kernel as nk
from transmil_deepgraft_tpu_torch.ops import translayer_kernel as tk
from transmil_deepgraft_tpu_torch.ops.depthwise import depthwise_conv1d

DIM, HEADS, M = 64, 2, 16
TOL = 5e-4  # the bar tests/test_pallas_nystrom.py holds the JAX fused layer to


class JaxRefLayer(fnn.Module):
    """The JAX TransLayer (XLA path) at a small width: LN + NystromAttentionLayer."""

    @fnn.compact
    def __call__(self, x):
        normed = fnn.LayerNorm(epsilon=1e-5, name="norm")(x)
        out, _, _ = JaxNystromLayer(dim=DIM, heads=HEADS, dim_head=DIM // HEADS,
                                    num_landmarks=M, name="attn")(normed, deterministic=True)
        return x + out


def _params(seed, ln_bias=0.5):
    """Flax-layout layer params from numpy, with a non-zero LayerNorm bias."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    return {
        "norm": {"scale": f32(1 + 0.1 * rng.standard_normal(DIM)),
                 "bias": f32(ln_bias * rng.standard_normal(DIM))},
        "attn": {
            "to_qkv": {"kernel": f32(rng.standard_normal((DIM, 3 * DIM)) / np.sqrt(DIM))},
            "to_out": {"kernel": f32(rng.standard_normal((DIM, DIM)) / np.sqrt(DIM)),
                       "bias": f32(0.1 * rng.standard_normal(DIM))},
            "res_conv": f32(rng.standard_normal((33, HEADS)) / np.sqrt(33)),
        },
    }


def _torch_weights(p):
    """Flax layer params -> the port's (ln_w, ln_b, w_qkv, w_out, b_out, res_weight)."""
    a = p["attn"]
    return tuple(torch.from_numpy(np.ascontiguousarray(w)) for w in (
        p["norm"]["scale"], p["norm"]["bias"], a["to_qkv"]["kernel"].T,
        a["to_out"]["kernel"].T, a["to_out"]["bias"], a["res_conv"].T[:, None, :, None],
    ))


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal((1, n, DIM)).astype(np.float32)


def _jax_xla_layer(p, x):
    return np.asarray(JaxRefLayer().apply({"params": p}, jnp.asarray(x)))


KW = dict(heads=HEADS, dim_head=DIM // HEADS, num_landmarks=M)


@pytest.mark.parametrize("n", [150, 131, 160])
@pytest.mark.parametrize("fn", [tk.fused_translayer, tk.fused_translayer_reference],
                         ids=["fused_cpu_path", "plain"])
def test_translayer_matches_jax_xla_layer(fn, n):
    """n = 150 and 131 front-pad (10 and 13 rows) under an LN bias of 0.5."""
    p, x = _params(n), _x(n, n)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), *_torch_weights(p), **KW).numpy()
    np.testing.assert_allclose(got, _jax_xla_layer(p, x), rtol=TOL, atol=TOL)


def test_translayer_matches_jax_fused_kernel_without_pad():
    """n = 160: no pad, so JAX's Pallas kernels (interpret mode) and the port
    compute the same function."""
    n = 160
    p, x = _params(7), _x(7, n)
    a = p["attn"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(
            jnp.asarray(x), p["norm"]["scale"], p["norm"]["bias"], a["to_qkv"]["kernel"],
            a["to_out"]["kernel"], a["to_out"]["bias"], a["res_conv"],
            block_n=64, **KW))
    with torch.no_grad():
        got = tk.fused_translayer(torch.from_numpy(x), *_torch_weights(p), **KW).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_jax_fused_kernel_front_pad_deviates_from_xla_layer():
    """Why the port does not follow JAX's fused kernels: padded BEFORE
    LayerNorm, their pad rows are LN(0) = ln_bias instead of zeros, and with a
    non-zero bias the layer output moves far from the XLA path's, which the
    port matches."""
    n = 150
    p, x = _params(11), _x(11, n)
    a = p["attn"]
    xp = np.pad(x, ((0, 0), (M - n % M, 0), (0, 0)))  # the caller's front pad, as in TransMIL
    with pltpu.force_tpu_interpret_mode():
        jf = np.asarray(jax_fused(
            jnp.asarray(xp), p["norm"]["scale"], p["norm"]["bias"], a["to_qkv"]["kernel"],
            a["to_out"]["kernel"], a["to_out"]["bias"], a["res_conv"], block_n=32, **KW))[:, -n:]
    xla = _jax_xla_layer(p, x)
    with torch.no_grad():
        port = tk.fused_translayer(torch.from_numpy(x), *_torch_weights(p), **KW).numpy()
    assert np.abs(jf - xla).max() > 0.1
    np.testing.assert_allclose(port, xla, rtol=TOL, atol=TOL)


def test_nystrom_layer_module_matches_jax_with_row():
    """The port's NystromAttentionLayer module (plain path) with its
    visualization row, against the JAX layer, n = 150 (front pad 10)."""
    n = 150
    p = _params(3)
    x = _x(3, n)
    jl = JaxNystromLayer(dim=DIM, heads=HEADS, dim_head=DIM // HEADS, num_landmarks=M)
    jout, jrow, jpad = jl.apply({"params": p["attn"]}, jnp.asarray(x), return_row_index=12)
    layer = NystromAttentionLayer(dim=DIM, heads=HEADS, dim_head=DIM // HEADS, num_landmarks=M)
    _, _, w_qkv, w_out, b_out, res_w = _torch_weights(p)
    layer.load_state_dict({"to_qkv.weight": w_qkv, "to_out.0.weight": w_out,
                           "to_out.0.bias": b_out, "res_conv.weight": res_w})
    layer.eval()
    with torch.no_grad():
        out, row, pad = layer(torch.from_numpy(x), return_row_index=12)
    assert pad == jpad == 10
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [5, 16, 100])
def test_landmark_pad(n):
    assert (n + tk.landmark_pad(n, 16)) % 16 == 0 and 0 <= tk.landmark_pad(n, 16) < 16


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper uses its plain version only for CPU tensors; any other
    device raises instead of falling back."""
    x = torch.empty((1, 8, 512), device="meta")
    with pytest.raises(ValueError):
        tk.translayer_k1(x, 0, x[0, 0], x[0, 0], x[0], x)
    with pytest.raises(ValueError):
        tk.translayer_k2(x, x, x[0, 0], x[0, 0], x[0], x, x, x[0], x[0, 0], 0.125)


def test_cpu_path_does_not_count_launches():
    tk.reset_launch_counts()
    p, x = _params(1), _x(1, 40)
    with torch.no_grad():
        tk.fused_translayer(torch.from_numpy(x), *_torch_weights(p), **KW)
    assert tk.LAUNCHES == {"translayer_k1": 0, "translayer_k2": 0}


def _plain_parts() -> tk._Parts:
    """The card path's launches as plain torch ops on the same buffers: the
    landmark attentions read K, V and Q, and write O, only through the
    (batch, head, row) strides the staging hands them."""
    def strided(t, b, h, rows, d, strides):
        return torch.as_strided(t, (b, h, rows, d), (*strides, 1))

    def project_kv(x, ln_weight, ln_bias, w_kv, kv, n_pad):
        y = F.layer_norm(x, x.shape[-1:], ln_weight, ln_bias, tk.LN_EPS) @ w_kv.t()
        kv[:, :, n_pad:] = y.unflatten(-1, (2, -1)).movedim(2, 0)

    def landmark(q_lm, k, v, strides, keys):
        b, h, _, d = q_lm.shape
        return nk.landmark_attention_reference(q_lm, strided(k, b, h, keys, d, strides),
                                               strided(v, b, h, keys, d, strides))

    def project_q(x, ln_weight, ln_bias, w_q, scale, q):
        q.copy_(F.layer_norm(x, x.shape[-1:], ln_weight, ln_bias, tk.LN_EPS) @ w_q.t() * scale)

    def query(q, k_lm, bmat, o, strides, n):
        b, h, _, d = k_lm.shape
        strided(o, b, h, n, d, strides).copy_(nk.query_landmark_attention_reference(
            strided(q, b, h, n, d, strides), k_lm, bmat))

    def project_out(o, res, x, w_out, b_out, y):
        y.copy_((o + res) @ w_out.t() + b_out + x)

    return tk._Parts(project_kv, landmark, project_q, query, project_out)


def test_card_staging_matches_plain_kernels_at_full_width():
    """K1 and K2 as the card runs them (``_k1_stages``/``_k2_stages``) with
    plain launches, at D 512, 8 heads of 64, 256 landmarks, b 2, n 300
    (front pad 212) under an LN bias of 0.5: within 1e-5 of k1_reference and
    k2_reference. The pad rows of both buffers are zero and V is the real
    rows of its buffer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    b, n, dim = 2, 300, 512

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(rng.standard_normal((b, n, dim)))
    ln_w, ln_b = t(1 + 0.1 * rng.standard_normal(dim)), t(0.5 * rng.standard_normal(dim))
    w_qkv = t(rng.standard_normal((3 * dim, dim)) / np.sqrt(dim))
    w_out = t(rng.standard_normal((dim, dim)) / np.sqrt(dim))
    b_out = t(0.1 * rng.standard_normal(dim))
    res_w = t(rng.standard_normal((8, 1, 33, 1)) / np.sqrt(33))
    n_pad = tk.landmark_pad(n, 256)
    keys = n + n_pad
    try:
        with torch.no_grad():
            q_lm, k_lm, pinv = tk.landmark_glue(x, n_pad, ln_w, ln_b, w_qkv, heads=8, dim_head=64,
                                                num_landmarks=256, pinv_iterations=6)
            k1_args = (x, n_pad, ln_w, ln_b, w_qkv[dim:], q_lm)
            got_a, got_v = tk._k1_stages(*k1_args, parts=_plain_parts())
            want_a, want_v = tk.k1_reference(*k1_args)
            assert (got_a - want_a).abs().max().item() <= 1e-5
            assert (got_v - want_v).abs().max().item() <= 1e-5
            assert got_v.stride() == (keys * dim, dim, 1)  # a view of the V buffer
            for plane in (0, 1):  # the K and V buffers' first n_pad rows of each batch
                pads = torch.as_strided(got_v, (b, n_pad, dim), (keys * dim, dim, 1),
                                        plane * b * keys * dim)
                assert not pads.any()

            bmat = (pinv @ got_a).contiguous()
            res = depthwise_conv1d(got_v, tk.value_residual_kernel(res_w, 64)).contiguous()
            k2_args = (x, res, ln_w, ln_b, w_qkv[:dim], k_lm, bmat, w_out, b_out, 0.125)
            got_y = tk._k2_stages(*k2_args, parts=_plain_parts())
            assert (got_y - tk.k2_reference(*k2_args)).abs().max().item() <= 1e-5
    finally:
        torch.set_num_threads(threads)
