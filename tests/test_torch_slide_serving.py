"""The port's slide bundles and its disk path against the JAX package's.

One int8 slide bundle exported by the JAX package (TransMIL with
out_features 32, 64x64 tiles, chunk 4, buckets (16, 32)) loads into the port:
its embed codes equal JAX's and its slide probabilities are within 1e-3
(the PARITY.md bar) of the JAX bundle's, on float and uint8 tiles, with and
without attention. A bf16 JAX slide bundle loads within 0.05 (bf16 rounds
at other places in the two packages). The port's own slide bundle
round-trips. The disk path (``predict_slide_paths*``) equals
``predict_slide*`` on the decoded tiles and JAX's ``predict_slide_paths*``
within 1e-3."""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_resnet import perturbed_resnet_variables
from transmil_deepgraft_tpu.inference import SlideInferencePipeline as JaxPipeline
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu.serving import ServingBundle as JaxBundle
from transmil_deepgraft_tpu.serving import export_slide_bundle as jax_export_slide_bundle
from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.serving import ServingBundle, export_slide_bundle
from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

PROB_TOL = 1e-3
N_TILES, CHUNK, SIZE, BUCKETS = 10, 4, 64, (16, 32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread is faster on a loaded CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX int8 slide bundle, its inputs and its outputs."""
    rng = np.random.default_rng(3)
    variables = perturbed_resnet_variables(3)
    tiles = rng.standard_normal((N_TILES, SIZE, SIZE, 3)).astype(np.float32)
    tiles_u8 = rng.integers(0, 256, (N_TILES, SIZE, SIZE, 3), dtype=np.uint8)
    jhead = JaxTransMIL(n_classes=2, in_features=2048, out_features=32)
    init = jax.jit(lambda key: jhead.init({"params": key}, jnp.zeros((1, N_TILES, 2048))))
    head_vars = jax.device_get(init(jax.random.key(1)))
    path = tmp_path_factory.mktemp("slide") / "int8.tdx"
    jax_export_slide_bundle(variables, jhead, head_vars, path, model_name="TransMIL",
                            in_features=2048, calib_tiles=tiles[:4], chunk=CHUNK, tile_hw=SIZE,
                            head_buckets=BUCKETS, platforms=("cpu",))
    jb = JaxBundle.load(path)
    want = {"codes": np.asarray(jb.embed_tiles(tiles_u8)),
            "float": jb.predict_slide(tiles), "uint8": jb.predict_slide(tiles_u8),
            "attention": jb.predict_slide_with_attention(tiles_u8)}
    return dict(path=path, variables=variables, head_vars=head_vars, tiles=tiles,
                tiles_u8=tiles_u8, want=want, dir=path.parent)


@pytest.fixture(scope="module")
def bundle(case):
    return ServingBundle.load(case["path"], device="cpu")


def test_port_loads_the_jax_int8_slide_bundle_bit_for_bit(case, bundle):
    """The backbone rebuilt from JAX's leaves: every int8 code the same, so
    the pooled features agree to float32 rounding of the pool."""
    assert bundle.meta["kind"] == "slide" and bundle.meta["n_classes"] == 2
    assert bundle._q.truncate_after == 4 and bundle._q.feature_dim == 2048
    got = bundle.embed_tiles(case["tiles_u8"]).numpy()
    half_share = float(bundle._q.final_scale) / (2 * (SIZE // 32) ** 2)
    np.testing.assert_allclose(got, case["want"]["codes"], atol=half_share, rtol=0)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_slide_predictions_match_the_jax_bundle(case, bundle, kind):
    tiles = case["tiles"] if kind == "float" else case["tiles_u8"]
    probs = bundle.predict_slide(tiles)
    assert probs.shape == (2,)
    np.testing.assert_allclose(probs, case["want"][kind], atol=PROB_TOL, rtol=0)


def test_slide_attention_matches_the_jax_bundle(case, bundle):
    probs, scores = bundle.predict_slide_with_attention(case["tiles_u8"])
    want_probs, want_scores = case["want"]["attention"]
    assert scores.shape == (N_TILES,)
    np.testing.assert_allclose(probs, want_probs, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(scores, want_scores, atol=1e-4, rtol=0)
    logits, _ = bundle.predict_slide_logits_with_attention(case["tiles_u8"])
    np.testing.assert_allclose(logits, bundle.predict_slide_logits(case["tiles_u8"]),
                               atol=PROB_TOL, rtol=0)


def test_bf16_jax_slide_bundle_loads(case, tmp_path):
    jhead = JaxTransMIL(n_classes=2, in_features=2048, out_features=32)
    path = tmp_path / "bf16.tdx"
    jax_export_slide_bundle(case["variables"], jhead, case["head_vars"], path,
                            model_name="TransMIL", in_features=2048, chunk=CHUNK, tile_hw=SIZE,
                            head_buckets=(16,), platforms=("cpu",), attention=False)
    bundle = ServingBundle.load(path, device="cpu")
    assert bundle.meta["backbone"] == "bf16"
    want = JaxBundle.load(path).predict_slide(case["tiles_u8"])
    np.testing.assert_allclose(bundle.predict_slide(case["tiles_u8"]), want, atol=0.05)


def test_port_slide_bundle_round_trips(case, bundle, tmp_path):
    """The port's own int8 bundle (params.npz, JAX's leaf order) serves what
    the port's pipeline built from the same variables and tiles serves."""
    meta = export_slide_bundle(case["variables"], case["head_vars"]["params"], tmp_path / "port.tdx",
                               model_name="TransMIL", in_features=2048, n_classes=2,
                               calib_tiles=case["tiles"][:4], chunk=CHUNK, tile_hw=SIZE,
                               head_buckets=BUCKETS, device="cpu")
    assert meta["kind"] == "slide" and meta["backbone"] == "int8" and meta["truncate_after"] == 4
    with zipfile.ZipFile(tmp_path / "port.tdx") as z:
        assert sorted(z.namelist()) == ["meta.json", "params.npz"]
    mine = ServingBundle.load(tmp_path / "port.tdx", device="cpu")
    got = mine.predict_slide(case["tiles_u8"])
    assert got.shape == (2,) and np.isfinite(got).all()
    # the port's own calibration moves a few codes (float64; see
    # tests/test_torch_inference.py), so the pipeline built the same way is
    # the yardstick: the same features, then the head on the bucket-padded bag
    own = SlideInferencePipeline(case["variables"], bundle.model, calib_tiles=case["tiles"][:4],
                                 chunk=CHUNK, device="cpu")
    feats = own.embed(case["tiles_u8"])
    np.testing.assert_array_equal(mine.embed_tiles(case["tiles_u8"]).numpy(), feats)
    np.testing.assert_allclose(got, mine.predict(feats)[0], atol=1e-6, rtol=0)


def test_backbone_leaves_are_checked(bundle):
    """Every int8 leaf's shape and dtype is checked, and a leaf count that
    matches no depth is refused."""
    from transmil_deepgraft_tpu_torch.serving import qresnet_from_leaves, qresnet_leaves

    leaves = qresnet_leaves(bundle._q)
    again = qresnet_leaves(qresnet_from_leaves(leaves, torch.device("cpu")))
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(leaves, again))
    bad = list(leaves)
    bad[4] = bad[4].astype(np.float32)  # layer1_0's w1, int8 in the file
    with pytest.raises(ValueError, match="layer1_0.w1"):
        qresnet_from_leaves(bad, torch.device("cpu"))
    with pytest.raises(ValueError, match="match no ResNet50 depth"):
        qresnet_from_leaves(leaves[:-1], torch.device("cpu"))


def test_oversize_slide_fails_before_the_embed(bundle, monkeypatch):
    def no_embed(*_):
        raise AssertionError("embedded a slide beyond the largest bucket")

    monkeypatch.setattr(bundle, "embed_tiles", no_embed)
    with pytest.raises(ValueError, match="largest exported bucket"):
        bundle.predict_slide(np.zeros((BUCKETS[-1] + 1, SIZE, SIZE, 3), np.uint8))


def test_integer_tiles_and_shapes_are_checked(case, bundle):
    wide = case["tiles_u8"][:2].astype(np.int64)  # raw pixels as JSON decodes them
    np.testing.assert_array_equal(bundle.embed_tiles(wide).numpy(),
                                  bundle.embed_tiles(case["tiles_u8"][:2]).numpy())
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        bundle.embed_tiles(wide + 300)
    with pytest.raises(ValueError, match="expected tiles"):
        bundle.embed_tiles(np.zeros((2, SIZE, SIZE + 1, 3), np.uint8))
    with pytest.raises(ValueError, match="not coord-aware"):
        bundle.predict_slide(case["tiles_u8"], coords=np.zeros((N_TILES, 2)))
    with pytest.raises(ValueError, match="not a slide bundle"):
        ServingBundle.embed_tiles(type("B", (), {"meta": {}})(), case["tiles_u8"])


@pytest.fixture(scope="module")
def slide_files(case):
    """The uint8 tiles as PNG files (lossless, so decoded == written), and
    the port pipeline with JAX's constants."""
    paths = []
    for i, tile in enumerate(case["tiles_u8"]):
        p = case["dir"] / f"tile_({i}-{i % 3}).png"
        Image.fromarray(tile).save(p)
        paths.append(p)
    return paths


def test_disk_path_equals_the_array_path_and_jax(case, bundle, slide_files):
    head = create_model("TransMIL", 2, 2048, 32, device="cpu")
    head.load_state_dict(state_dict_from_jax(case["head_vars"]["params"], 2048))
    pipe = SlideInferencePipeline(case["variables"], head, calib_tiles=case["tiles"][:4],
                                  chunk=CHUNK, device="cpu")
    pipe._q = bundle._q  # JAX's constants, from the bundle
    probs = pipe.predict_slide_paths(slide_files, tile_size=SIZE)
    np.testing.assert_array_equal(probs, pipe.predict_slide(case["tiles_u8"]))
    attn_probs, scores = pipe.predict_slide_paths_with_attention(slide_files, tile_size=SIZE)
    want_probs, want_scores = pipe.predict_slide_with_attention(case["tiles_u8"])
    np.testing.assert_array_equal(attn_probs, want_probs)
    np.testing.assert_array_equal(scores, want_scores)

    jhead = JaxTransMIL(n_classes=2, in_features=2048, out_features=32)
    jpipe = JaxPipeline(case["variables"], jhead, case["head_vars"],
                        calib_tiles=case["tiles"][:4], chunk=CHUNK)
    np.testing.assert_allclose(probs, jpipe.predict_slide_paths(slide_files, tile_size=SIZE),
                               atol=PROB_TOL, rtol=0)
    j_probs, j_scores = jpipe.predict_slide_paths_with_attention(slide_files, tile_size=SIZE)
    np.testing.assert_allclose(attn_probs, j_probs, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(scores, j_scores, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="empty"):
        pipe.predict_slide_paths([], tile_size=SIZE)
