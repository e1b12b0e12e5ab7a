"""Serving the spatial heads (CTMIL, the ``resnet50`` head) on the CPU,
against the JAX package's bundles and CLIs.

JAX's CTMIL and SpatialResNetMIL lift a (B, n, D) bag to one (1, B, n, D)
grid (``models/ctmil.py:35-36``, ``models/spatial_resnet.py:25-26``), so
their serving bundles take bags: a batch-1 bag is a 1 x n strip, zero-padded
to the bucket. JAX exports CTMIL with attention (layer 2's row over the
pooled grid's tokens, averaged into the tile count's shape by the bundle's
``_attn_forward``) and the ResNet without. The port loads JAX's bundles
(params and BatchNorm statistics), writes its own (from arrays, from a
torch ``.pth`` and from a flax checkpoint through ``cli.export_model``), and
serves both as JAX's forwards do on the padded bag: logits and scores within
1e-4 (float32 convolutions summed in another order). ``cli.infer --model
CTMIL`` gives JAX's CLI's probabilities and top-k scores where the row's
size is a multiple of the slide's tile count, and raises JAX's error where
it is not (ROADMAP C21).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from chip_smoke import torchvision_state_dict
from tests.test_torch_resnet import perturbed_resnet_variables
from transmil_deepgraft_tpu import serving as jax_serving
from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu_torch.cli import export_model, infer
from transmil_deepgraft_tpu_torch.serving import ServingBundle, export_serving_bundle
from transmil_deepgraft_tpu_torch.utils.jax_params import head_state_dict_from_jax

IN_F, N_TILES, BUCKET, TOL = 32, 50, 64, 1e-4
NAMES = ["CTMIL", "resnet50"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers on the
    machine's cores, and the port's plain paths are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(jmodel, in_features: int, seed: int) -> dict:
    """Flax ``{'params', 'batch_stats'}`` at ``jax.eval_shape``'s shapes,
    from one seed: kernels at 1/sqrt(fan-in), norms near 1, and the
    statistics a trained head would carry."""
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.key(0)},
                            jax.ShapeDtypeStruct((1, 8, 8, in_features), jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, z = path[-1].key, rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return 1 + 0.1 * z if name == "scale" else 0.1 * z

    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes["params"]),
            "batch_stats": jax.tree.map(
                lambda s: np.abs(rng.standard_normal(s.shape)).astype(np.float32) + 0.5,
                shapes["batch_stats"])}


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """Per head, built once: JAX's model and variables, JAX's bundle, the
    bag, and JAX's logits (and CTMIL's scores) on the padded bag."""
    root = tmp_path_factory.mktemp("spatial")
    bag = np.random.default_rng(1).standard_normal((N_TILES, IN_F)).astype(np.float32)
    padded = jnp.asarray(np.pad(bag, ((0, BUCKET - N_TILES), (0, 0)))[None])
    out = {}
    for seed, name in enumerate(NAMES):
        jmodel = jax_create_model(name, 2, IN_F, 16) if name == "CTMIL" else jax_create_model(
            name, 2, IN_F)
        variables = _variables(jmodel, IN_F, seed)
        path = root / f"{name}.tdx"
        jmeta = jax_serving.export_serving_bundle(jmodel, variables, path, model_name=name,
                                                  in_features=IN_F, buckets=(BUCKET,),
                                                  platforms=("cpu",), symbolic=False)
        assert jmeta["attention"] == (name == "CTMIL")
        if name == "CTMIL":
            logits, scores = jax.device_get(jax_serving._attn_forward(jmodel)(variables, padded))
            scores = scores[:, :N_TILES]
        else:
            logits, scores = np.asarray(jax.jit(
                lambda v, x: jmodel.apply(v, x, deterministic=True))(variables, padded)), None
        out[name] = {"variables": variables, "bundle": path, "bag": bag,
                     "logits": np.asarray(logits), "scores": scores}
    return out


def _check_serves(path, name, case) -> None:
    bundle = ServingBundle.load(path, device="cpu")
    assert bundle.meta["model_name"] == name
    np.testing.assert_allclose(bundle.predict_logits(case["bag"]), case["logits"], atol=TOL,
                               rtol=0)
    if name == "CTMIL":
        got_logits, got = bundle.predict_logits_with_attention(case["bag"])
        np.testing.assert_allclose(got_logits, case["logits"], atol=TOL, rtol=0)
        np.testing.assert_allclose(got, case["scores"], atol=TOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_port_serves_jax_spatial_bundles(name, spatial, tmp_path):
    case = spatial[name]
    variables = case["variables"]
    port_path = tmp_path / "port.tdx"
    export_serving_bundle({**variables["params"], "batch_stats": variables["batch_stats"]},
                          port_path, model_name=name, in_features=IN_F, n_classes=2,
                          buckets=(BUCKET,))
    for p in (case["bundle"], port_path):
        _check_serves(p, name, case)
    with pytest.raises(ValueError, match="BatchNorm statistics"):
        export_serving_bundle(variables["params"], tmp_path / "x.tdx", model_name=name,
                              in_features=IN_F, n_classes=2, buckets=(BUCKET,))


@pytest.mark.parametrize("name", NAMES)
def test_cli_export_model_takes_spatial_heads(name, spatial, tmp_path):
    """``cli.export_model --model <spatial head>`` from a port ``.pth`` (the
    BatchNorm statistics among the state dict's buffers) and from a JAX
    flax checkpoint ({'params', 'batch_stats'}): both bundles serve as JAX's
    forward does."""
    case = spatial[name]
    variables = case["variables"]
    torch.save(head_state_dict_from_jax(name, variables["params"], IN_F,
                                        batch_stats=variables["batch_stats"]),
               tmp_path / "head.pth")
    (tmp_path / "head.msgpack").write_bytes(serialization.msgpack_serialize(variables))
    for ckpt in ("head.pth", "head.msgpack"):
        out = tmp_path / f"{ckpt}.tdx"
        meta = export_model.main(["--model", name, "--ckpt", str(tmp_path / ckpt), "--out",
                                  str(out), "--in_features", str(IN_F), "--buckets",
                                  str(BUCKET)])
        assert meta["attention"] == (name == "CTMIL")
        _check_serves(out, name, case)


def test_cli_infer_ctmil_matches_the_jax_cli(tmp_path, monkeypatch):
    """``cli.infer --model CTMIL`` (int8 backbone, head out_features 32: 8
    heads x 16 landmark-padded tokens in layer 2's row) over two slides, in
    one run of each CLI: on the 4-tile slide the port gives JAX's
    probabilities and top-k scores (each pipeline's per-slide result is
    recorded as it returns); on the 5-tile slide both CLIs raise the same
    ValueError, the row's 128 entries being no multiple of 5 (ROADMAP C21).
    JAX's CLI reads the head from a flax checkpoint, the port's from a
    ``.pth``."""
    from transmil_deepgraft_tpu import inference as jax_inference
    from transmil_deepgraft_tpu.cli.infer import main as jax_infer
    from transmil_deepgraft_tpu_torch import inference as port_inference

    torch.save(torchvision_state_dict(perturbed_resnet_variables(5)), tmp_path / "bb.pth")
    variables = _variables(jax_create_model("CTMIL", 2, 2048, 32), 2048, 3)
    (tmp_path / "head.msgpack").write_bytes(serialization.msgpack_serialize(variables))
    torch.save(head_state_dict_from_jax("CTMIL", variables["params"], 2048,
                                        batch_stats=variables["batch_stats"]),
               tmp_path / "head.pth")
    rng = np.random.default_rng(6)
    for slide, n in (("slideA", 4), ("slideB", 5)):
        d = tmp_path / "tiles" / slide
        d.mkdir(parents=True)
        for t in range(n):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                d / f"tile_({t}-{t + 1}).jpg", quality=90)

    results = {}
    for key, module in (("jax", jax_inference), ("port", port_inference)):
        cls = module.SlideInferencePipeline
        run = cls.predict_slide_paths_with_attention

        def recorded(self, paths, *a, _key=key, _run=run, **kw):
            out = _run(self, paths, *a, **kw)
            results.setdefault(_key, []).append((len(paths), *map(np.asarray, out)))
            return out

        monkeypatch.setattr(cls, "predict_slide_paths_with_attention", recorded)

    def args(out, head):
        return ["--tiles_root", str(tmp_path / "tiles"), "--backbone_ckpt",
                str(tmp_path / "bb.pth"), "--head_ckpt", str(tmp_path / head), "--model",
                "CTMIL", "--quantize", "int8", "--out_features", "32", "--chunk", "4",
                "--tile_size", "64", "--topk", "4", "--out_dir", str(tmp_path / out)]

    for run, out, head, extra in ((jax_infer, "jax", "head.msgpack", []),
                                  (infer.main, "port", "head.pth", ["--device", "cpu"])):
        with pytest.raises(ValueError, match=r"\(1, 8, 16\) is not a multiple of the tile count 5"):
            run(args(out, head) + extra)
    ((n, want_probs, want_scores),), ((m, probs, scores),) = results["jax"], results["port"]
    assert n == m == 4
    np.testing.assert_allclose(probs, want_probs, atol=TOL, rtol=0)
    np.testing.assert_allclose(scores, want_scores, atol=TOL, rtol=0)
    ours, jaxs = ([row[3] for row in csv.reader(open(tmp_path / out / "slideA_topk_tiles.csv"))][1:]
                  for out in ("port", "jax"))
    np.testing.assert_allclose(np.float64(ours), np.float64(jaxs), atol=TOL, rtol=0)
