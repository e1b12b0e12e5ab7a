"""The port's ``SlideInferencePipeline`` against the JAX package's on the same
backbone variables, TransMIL-2048 head weights and tiles.

With the int8 constants carried across (``qresnet_from_jax``) the features
agree within half of one code's share (so no int8 code differs) and the
probabilities within 1e-3 (the PARITY.md bar), for float and raw uint8 tiles
(normalized on the device), through ``predict_slide`` and
``predict_slide_with_attention``, with a ragged last chunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_resnet import perturbed_resnet_variables
from transmil_deepgraft_tpu.inference import SlideInferencePipeline as JaxPipeline
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline, chunked_device_embed
from transmil_deepgraft_tpu_torch.models import build_qresnet50, create_model
from transmil_deepgraft_tpu_torch.utils.jax_params import qresnet_from_jax, state_dict_from_jax

PROB_TOL = 1e-3
SCORE_TOL = 1e-4
N_TILES, CHUNK, SIZE = 10, 4, 64  # 3 chunks, the last one ragged (2 of 4)


def port_head(params):
    head = create_model("TransMIL", 2, 2048, 32, device="cpu")
    head.load_state_dict(state_dict_from_jax(params, 2048))
    return head


@pytest.fixture(scope="module")
def case():
    """Variables, JAX head params, float and uint8 tiles, and the JAX int8
    pipeline's outputs on both."""
    rng = np.random.default_rng(3)
    variables = perturbed_resnet_variables(3)
    tiles = rng.standard_normal((N_TILES, SIZE, SIZE, 3)).astype(np.float32)
    tiles_u8 = rng.integers(0, 256, (N_TILES, SIZE, SIZE, 3), dtype=np.uint8)
    jhead = JaxTransMIL(n_classes=2, in_features=2048, out_features=32)
    init = jax.jit(lambda key: jhead.init({"params": key}, jnp.zeros((1, N_TILES, 2048))))
    params = jax.device_get(init(jax.random.key(1)))["params"]
    jpipe = JaxPipeline(variables, jhead, {"params": params}, calib_tiles=tiles[:4], chunk=CHUNK)
    want = {}
    for kind, t in (("float", tiles), ("uint8", tiles_u8)):
        want[kind] = (np.asarray(jpipe.embed_device(t)), jpipe.predict_slide(t),
                      *jpipe.predict_slide_with_attention(t))
    return variables, params, tiles, tiles_u8, jax.device_get(jpipe._q), want


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain int8 path is float64 matmuls: one intra-op thread keeps the
    CPU for the test workers running beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_pipeline(case, **kwargs):
    variables, params, tiles, _, jq, _ = case
    pipe = SlideInferencePipeline(variables, port_head(params), calib_tiles=tiles[:4],
                                  chunk=CHUNK, device="cpu", **kwargs)
    return pipe, jq


@pytest.fixture(scope="module")
def port(case):
    """One port pipeline with its own calibration, and what that calibration
    gives (the float tiles' features, whole and by prefix, and
    probabilities); then the same pipeline with JAX's int8 constants carried
    across (``qresnet_from_jax``). One calibration serves every test but the
    fused one."""
    pipe, jq = port_pipeline(case)
    tiles = case[2]
    own = {"feats": pipe.embed(tiles), "probs": pipe.predict_slide(tiles),
           "prefix": {n: pipe.embed(tiles[:n]) for n in (1, 5, 7)}}
    pipe._q = qresnet_from_jax(jq)
    return pipe, jq, own


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_pipeline_matches_jax_with_carried_constants(case, port, kind):
    pipe, jq, _ = port
    tiles = case[2] if kind == "float" else case[3]
    want_feats, want_probs, want_attn_probs, want_scores = case[5][kind]
    half_share = float(jq.final_scale) / (2 * 2 * 2)
    np.testing.assert_allclose(pipe.embed(tiles), want_feats, atol=half_share, rtol=0)
    probs = pipe.predict_slide(tiles)
    assert probs.shape == (2,)
    np.testing.assert_allclose(probs, want_probs, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    attn_probs, scores = pipe.predict_slide_with_attention(tiles)
    assert scores.shape == (N_TILES,)
    np.testing.assert_allclose(attn_probs, want_attn_probs, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(scores, want_scores, atol=SCORE_TOL, rtol=0)


def test_pipeline_own_calibration_close_to_jax(case, port):
    """The port's own calibration (float64, see tests/test_torch_resnet_int8.py)
    moves a few int8 codes: features are held by cosine, and probabilities to
    1e-2 rather than 1e-3."""
    own = port[2]
    want_feats, want_probs = case[5]["float"][:2]
    feats = own["feats"]
    cos = (feats * want_feats).sum(-1) / (
        np.linalg.norm(feats, axis=-1) * np.linalg.norm(want_feats, axis=-1))
    assert cos.min() > 0.9999, cos
    np.testing.assert_allclose(own["probs"], want_probs, atol=1e-2, rtol=0)


def test_fused_backbone_and_ragged_chunks(case, port):
    """The fused segment control gives the same codes as the plain one under
    the same (own) calibration; the zero pad of the last chunk changes no
    real tile's features (tiles are independent)."""
    own = port[2]
    fused, _ = port_pipeline(case, fused_backbone=True, fused_t_cfg=(1, 0, 2, 0, 4, 1, 0))
    full = own["feats"]
    np.testing.assert_array_equal(fused.embed(case[2]), full)
    for n in (1, 5, 7):
        np.testing.assert_array_equal(own["prefix"][n], full[:n])
    with pytest.raises(ValueError, match="does not divide"):
        port_pipeline(case, fused_backbone=True, fused_t_cfg=(1, 1, 3, 1, 1, 1, 1))


def test_bf16_route_close_to_jax(case):
    """``calib_tiles=None`` runs the float ResNet50 in bf16 in both packages;
    bf16 rounds at other places in the two, hence the loose bar (the JAX
    package's own int8-vs-bf16 bar in tests/test_inference_pipeline.py)."""
    variables, params, tiles = case[:3]
    jhead = JaxTransMIL(n_classes=2, in_features=2048, out_features=32)
    jpipe = JaxPipeline(variables, jhead, {"params": params}, calib_tiles=None, chunk=CHUNK)
    pipe = SlideInferencePipeline(variables, port_head(params), chunk=CHUNK, device="cpu")
    want = np.asarray(jpipe.embed_device(tiles))
    got = pipe.embed(tiles)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.99, cos
    np.testing.assert_allclose(pipe.predict_slide(tiles), jpipe.predict_slide(tiles), atol=0.05)


def test_pipeline_needs_cuda_unless_cpu_is_asked_for(case):
    if torch.cuda.is_available():  # device=None is valid with a card
        return
    variables, params, tiles = case[:3]
    with pytest.raises(RuntimeError, match="CUDA"):
        SlideInferencePipeline(variables, port_head(params), calib_tiles=tiles[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_qresnet50(variables, tiles[:2])


def test_chunked_device_embed_rejects_an_empty_batch():
    with pytest.raises(ValueError, match="empty"):
        chunked_device_embed(lambda b: torch.zeros(len(b), 4), np.zeros((0, 8, 8, 3)), 4)
