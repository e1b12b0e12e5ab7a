"""The port's int8 ResNet50 (``models/resnet_int8``) against the JAX package's
XLA ``apply_qresnet50`` on the same seeded inputs.

With the constants carried across (``qresnet_from_jax``) the features must
agree within half of one code's share of a pooled feature,
``final_scale / (2 h w)``, so that a single differing int8 code anywhere in
the last stage fails. The port's own ``build_qresnet50`` calibrates in
float64 where JAX uses float32 (bf16 stem), so it is held to equal weight
codes, scales within a relative 1e-5, fma offsets within 1e-2 of a code, and a
feature cosine above 0.9999."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_resnet import perturbed_resnet_variables
from transmil_deepgraft_tpu.models import resnet_int8 as J
from transmil_deepgraft_tpu_torch.models import resnet_int8 as P
from transmil_deepgraft_tpu_torch.models.resnet import resnet50
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    qresnet_from_jax,
    resnet_state_dict_from_jax,
)

SIZE = 64  # tiles of 64x64: the last stage is 2x2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers on the
    machine's cores, and the port's plain paths are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def half_code_share(q, size=SIZE, truncate_after=4):
    side = size // (4 * 2 ** (truncate_after - 1))
    return float(q.final_scale) / (2 * side * side)


@pytest.fixture(scope="module")
def net():
    """(variables, calibration tiles, test tiles, JAX q, JAX features)."""
    rng = np.random.default_rng(6)
    v = perturbed_resnet_variables(6)
    calib = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    x = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    q = J.build_qresnet50(v, calib)
    want = np.asarray(jax.jit(J.apply_qresnet50)(q, jnp.asarray(x)))
    return v, calib, x, jax.device_get(q), want


def test_apply_qresnet50_matches_jax_code_for_code(net):
    _, _, x, q, want = net
    got = P.apply_qresnet50(qresnet_from_jax(q), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 2048)
    np.testing.assert_allclose(got, want, atol=half_code_share(q), rtol=0)


@pytest.mark.parametrize("t_cfg", [(1, 1, 3, 3, 1, 1, 3), (1, 0, 3, 0, 0, 1, 0), (0,) * 7],
                         ids=["kernels", "mixed", "all_plain"])
def test_apply_qresnet50_fused_matches_jax_xla_path(net, t_cfg):
    _, _, x, q, want = net
    prep = P.prepare_qresnet50_fused(qresnet_from_jax(q))
    got = P.apply_qresnet50_fused(prep, torch.from_numpy(x), t_cfg=t_cfg).numpy()
    np.testing.assert_allclose(got, want, atol=half_code_share(q), rtol=0)


def test_fused_segments_check_tiles_per_step(net):
    _, _, x, q, _ = net
    prep = P.prepare_qresnet50_fused(qresnet_from_jax(q))
    with pytest.raises(ValueError, match="divisible"):
        P.apply_qresnet50_fused(prep, torch.from_numpy(x), t_cfg=(2, 1, 1, 1, 1, 1, 1))


def test_truncated_baseline_matches_jax(net):
    """truncate_after=3 (the CLAM baseline, 1024-d)."""
    v, calib, x, _, _ = net
    q3 = J.build_qresnet50(v, calib, truncate_after=3)
    want = np.asarray(jax.jit(J.apply_qresnet50)(q3, jnp.asarray(x)))
    port_q3 = qresnet_from_jax(jax.device_get(q3))
    got = P.apply_qresnet50(port_q3, torch.from_numpy(x)).numpy()
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got, want, atol=half_code_share(q3, truncate_after=3), rtol=0)
    with pytest.raises(ValueError, match="4-stage"):
        P.prepare_qresnet50_fused(port_q3)


def test_own_build_matches_jax_build(net):
    v, calib, x, q, want = net
    own = P.build_qresnet50(v, calib, device="cpu")
    ported = qresnet_from_jax(q)
    assert own.truncate_after == 4 and own.feature_dim == 2048

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    for name in ("input_scale", "final_scale", "stem_m"):
        assert rel(getattr(own, name), getattr(ported, name)) < 1e-5, name
    assert torch.equal(own.stem_w, ported.stem_w)
    assert float((own.stem_z - ported.stem_z).abs().max()) < 1e-2
    for b_own, b_jax in zip(own.blocks, ported.blocks):
        for field in ("w1", "w2", "w3", "wd"):
            a, b = getattr(b_own, field), getattr(b_jax, field)
            assert (a is None and b is None) or torch.equal(a, b), field
        for field in ("m1", "m2", "m3", "md", "id_mult"):
            a, b = getattr(b_own, field), getattr(b_jax, field)
            assert (a is None and b is None) or rel(a, b) < 1e-5, field
        for field in ("z1", "z2", "z3"):
            assert float((getattr(b_own, field) - getattr(b_jax, field)).abs().max()) < 1e-2
    got = P.apply_qresnet50(own, torch.from_numpy(x)).numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999, cos


def test_int8_feature_fidelity_vs_fp32(net):
    """The bar of tests/test_int8_resnet.py: cosine > 0.999 against the float
    model, both in the port."""
    v, calib, x, _, _ = net
    model = resnet50()
    model.load_state_dict(resnet_state_dict_from_jax(v))
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).numpy()
    got = P.apply_qresnet50(P.build_qresnet50(v, calib, device="cpu"),
                            torch.from_numpy(x)).numpy()
    cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))
    assert cos.min() > 0.999, cos


def test_requant_epilogues_match_jitted_xla_bit_for_bit():
    """~1M random (acc, m, z) and residual terms through JAX's jitted
    ``acc * m + z`` (XLA:CPU contracts it into one fma) and the residual sum,
    against the port's float64 emulation. Counts differing codes, and shows
    that the float32 two-step (round after the product) would differ."""
    rng = np.random.default_rng(0)
    n, c = 8192, 128
    acc = rng.integers(-(2 ** 26), 2 ** 26, (n, c), dtype=np.int32)
    m = rng.uniform(2e-7, 3e-6, c).astype(np.float32)  # |acc * m| up to ~200
    z = rng.uniform(-140.0, 60.0, c).astype(np.float32)
    x = rng.integers(-128, 128, (n, c), dtype=np.int8)
    id_mult = np.float32(0.8137)
    accd = rng.integers(-(2 ** 26), 2 ** 26, (n, c), dtype=np.int32)
    md = rng.uniform(2e-7, 3e-6, c).astype(np.float32)

    rq = jax.jit(J._rq)
    want = np.asarray(rq(acc, m, z))
    got = P._rq(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(z)).numpy()
    assert int((got != want).sum()) == 0

    @jax.jit
    def residual(acc3, x, accd):
        a3 = acc3.astype(jnp.float32) * m
        ident = jnp.clip(jnp.round(a3 + x.astype(jnp.float32) * id_mult + z), -128, 127)
        proj = jnp.clip(jnp.round(a3 + accd.astype(jnp.float32) * md + z), -128, 127)
        return ident.astype(jnp.int8), proj.astype(jnp.int8)

    want_id, want_ds = (np.asarray(a) for a in residual(acc, x, accd))
    t = {k: torch.from_numpy(a) for k, a in
         (("acc", acc), ("m", m), ("z", z), ("x", x), ("accd", accd), ("md", md))}
    got_id = P._rq_residual(t["acc"], t["m"], t["x"].float() * float(id_mult), t["z"]).numpy()
    got_ds = P._rq_residual(t["acc"], t["m"], t["accd"].float() * t["md"], t["z"]).numpy()
    assert int((got_id != want_id).sum()) == 0
    assert int((got_ds != want_ds).sum()) == 0

    # the float32 two-step rounds the product first: it lands on other values
    two_step = t["acc"].float() * t["m"] + t["z"]
    fma_vals = np.asarray(jax.jit(lambda a: a.astype(jnp.float32) * m + z)(acc))
    assert int((two_step.numpy() != fma_vals).sum()) > 0
