"""The TPU layout variants of the int8 ResNet50 in the port
(``models/resnet_int8``: ``apply_stage_wpacked_xla``,
``apply_qresnet50_wpack1``, ``build_bf16_stage1`` +
``apply_qresnet50_bf16s1``) against the JAX package's, on the same seeded
weights and tiles (64 x 64, the last stage 2 x 2).

Bars: the packed stage's codes bit for bit with JAX's; the packed-stage-1
forward bit for bit with the port's own ``apply_qresnet50`` and within half
of one code's share of a pooled feature of JAX's (as
``tests/test_torch_resnet_int8.py`` holds ``apply_qresnet50``); the bf16
stage-1 variant at feature cosine >= 0.9999 to JAX's, with at most 1% of
stage 2's input codes one off and none further (the port calibrates in
float64 where JAX calibrates in float32, which moves the stage-2 scale in
its last bits); and JAX's own fidelity bar (``tests/test_int8_resnet.py``)
held on the port: cosine > 0.999 to the float32 network and at least the
full int8 path's cosine less 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_resnet import perturbed_resnet_variables
from tests.test_torch_resnet_int8 import half_code_share
from transmil_deepgraft_tpu.models import resnet_int8 as J
from transmil_deepgraft_tpu_torch.models import resnet_int8 as P
from transmil_deepgraft_tpu_torch.models.resnet import resnet50
from transmil_deepgraft_tpu_torch.ops.qstage_kernel import pack_wpair_block
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    qresnet_from_jax,
    resnet_state_dict_from_jax,
)

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def net():
    """(variables, calibration tiles, test tiles, JAX q, the port's q
    carried from it)."""
    rng = np.random.default_rng(8)
    v = perturbed_resnet_variables(8)
    calib = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    x = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    q = jax.device_get(J.build_qresnet50(v, calib))
    return v, calib, x, q, qresnet_from_jax(q)


def _cos(a, b):
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
                                      + 1e-12)).min())


def test_packed_stage_matches_jax_bit_for_bit(net):
    """Stage 1 on the W-pair-packed grid, plain, from the same input codes:
    JAX's ``apply_stage_wpacked_xla`` with JAX's packed blocks and the
    port's with ``pack_wpair_block``'s give the same codes, which are the
    unpacked block loop's."""
    _, _, _, q, pq = net
    rng = np.random.default_rng(1)
    x_q = rng.integers(-128, 128, (2, SIZE // 4, SIZE // 4, 64), dtype=np.int8)
    jprep = jax.device_get(J.prepare_qresnet50_fused(q))
    want = np.asarray(jax.jit(J.apply_stage_wpacked_xla)(jnp.asarray(x_q), jprep.stage1_packed))
    packed = [pack_wpair_block(b) for b in pq.blocks[0:3]]
    got = P.apply_stage_wpacked_xla(torch.from_numpy(x_q), packed).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, P._plain_blocks(torch.from_numpy(x_q), pq.blocks[0:3],
                                                       [1, 1, 1]).numpy())


def test_wpack1_matches_jax_and_apply_qresnet50(net):
    _, _, x, q, pq = net
    want = np.asarray(jax.jit(J.apply_qresnet50_wpack1)(J.prepare_qresnet50_fused(q),
                                                        jnp.asarray(x)))
    got = P.apply_qresnet50_wpack1(P.prepare_qresnet50_fused(pq), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, P.apply_qresnet50(pq, torch.from_numpy(x)).numpy())
    assert got.shape == want.shape == (3, 2048)
    np.testing.assert_allclose(got, want, atol=half_code_share(q), rtol=0)


def _jax_stage2_codes(s1, tiles):
    """The first half of JAX's ``apply_qresnet50_bf16s1``, written out: the
    bf16 stem, max-pool and stage 1, then the quantization into stage 2's
    input code."""
    h = jax.lax.conv_general_dilated(
        tiles.astype(jnp.bfloat16), s1.stem_k, (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    h = jax.nn.relu(h + s1.stem_b)
    h = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                              [(0, 0), (1, 1), (1, 1), (0, 0)])
    for parts in s1.convs:
        k1, b1, k2, b2, k3, b3 = parts[:6]
        y = jax.nn.relu(J._conv_bf16(h, k1) + b1)
        y = jax.nn.relu(J._conv_bf16(y, k2) + b2)
        y = J._conv_bf16(y, k3) + b3
        idn = J._conv_bf16(h, parts[6]) + parts[7] if len(parts) == 8 else h
        h = jax.nn.relu(y + idn)
    return jnp.clip(jnp.round(h / s1.out_scale) - 128.0, -128, 127).astype(jnp.int8)


@pytest.fixture(scope="module")
def bf16(net):
    """(JAX's features and stage-2 codes, the port's, from each package's
    own build on the same calibration tiles)."""
    v, calib, x, q, _ = net
    s1 = J.build_bf16_stage1(v, calib)
    want = np.asarray(jax.jit(J.apply_qresnet50_bf16s1)(q, s1, jnp.asarray(x)))
    want_codes = np.asarray(jax.jit(_jax_stage2_codes)(s1, jnp.asarray(x)))
    pq = P.build_qresnet50(v, calib, device="cpu")
    ps1 = P.build_bf16_stage1(v, calib, device="cpu")
    got = P.apply_qresnet50_bf16s1(pq, ps1, torch.from_numpy(x)).numpy()
    got_codes = P._bf16_stage1_codes(ps1, torch.from_numpy(x)).numpy()
    return want, want_codes, got, got_codes, pq


def test_bf16_stage1_variant_matches_jax(bf16):
    want, want_codes, got, got_codes, _ = bf16
    assert got.shape == want.shape == (3, 2048)
    assert _cos(got, want) >= 0.9999, _cos(got, want)
    assert got_codes.shape == want_codes.shape == (3, SIZE // 4, SIZE // 4, 256)
    off = np.abs(got_codes.astype(np.int32) - want_codes.astype(np.int32))
    assert off.max() <= 1, off.max()
    assert (off == 1).mean() <= 0.01, (off == 1).mean()


def test_bf16_stage1_fidelity_on_the_port(net, bf16):
    """JAX's bar (tests/test_int8_resnet.py): the mixed variant at least as
    faithful to the float32 network as the full int8 path, less 1e-4, and
    above 0.999; all three networks the port's."""
    v, _, x, _, _ = net
    *_, got, _, pq = bf16
    model = resnet50()
    model.load_state_dict(resnet_state_dict_from_jax(v))
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).numpy()
    full = P.apply_qresnet50(pq, torch.from_numpy(x)).numpy()
    assert _cos(ref, got) >= _cos(ref, full) - 1e-4, (_cos(ref, got), _cos(ref, full))
    assert _cos(ref, got) > 0.999
