"""The port's heatmaps and CAMs against the JAX package's, on the CPU.

- every ``CAM_METHODS`` entry and ``score_cam`` on the same activations and
  gradients: within 1e-5 of the map's largest value (float32 sums in
  another order); ``normalize_cam``, ``jet_colormap`` and
  ``show_cam_on_image`` equal;
- ``assemble_heatmap``, ``assemble_pixel_attention_map`` (also against
  ``tests/torch_ref/heatmap_oracle.py``, 2e-5 as JAX's golden test) and
  ``roi_mask``: equal to JAX's (the same numpy/scipy code, 1e-12);
- ``save_heatmap_jpeg``: the same JPEG bytes as JAX's on the same map, with
  the port's own 'jet' table (equal to matplotlib's) and with a matplotlib
  colormap;
- ``deep_feature_factorization``: the port's numpy NMF against
  scikit-learn's (JAX's) on a seeded well-conditioned rank-4 matrix: W, H
  within 1e-9 of their largest entry (1.8e-14 reached: scikit-learn's
  randomized SVD converges there);
- ``Visualizer.run_slide`` on a 512-wide TransMIL from JAX's weights: the
  logits within 1e-4, attention and GradCAM scores within 1e-3 (the port's
  layers plain, and with ``use_pallas``: the landmark kernels' plain
  versions and their analytic backward), the top-k CSV the same tiles in
  the same order, the scores within 1e-3; GradCAM calls ``fused_translayer``
  no time while an inference-mode eval forward still calls it twice;
- ``ImageVisualizer`` over a ResNet18 + TransMIL (gradcam): logits and
  attention within 1e-4, pixel CAMs within 1e-4;
- ``cli.visualize`` of both packages on one config and one JAX checkpoint:
  the same slides, logits within 1e-4, the same files and top-k tiles;
- both packages' k-fold runs, each fold from the same weights: every
  fold's ``Trainer.test`` writes ``topk_tiles/*.csv`` with the tiles of
  JAX's in the same order (scores within 1e-3), the ensemble its
  ``ensemble_topk_tiles/`` likewise, and the epoch and test figures are
  the files of JAX's; without matplotlib the figures are skipped with
  JAX's printed lines.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from tests.torch_ref.heatmap_oracle import reference_attention_mask
from transmil_deepgraft_tpu.cli import visualize as jcli
from transmil_deepgraft_tpu.data.datamodule import MILDataModule as JaxDataModule
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu.models.resnet import resnet18 as jresnet18
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from transmil_deepgraft_tpu.train.trainer import Trainer as JaxTrainer
from transmil_deepgraft_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from transmil_deepgraft_tpu.utils.checkpoints import save_pytree
from transmil_deepgraft_tpu.visualize import cam as jcam
from transmil_deepgraft_tpu.visualize import heatmap as jheat
from transmil_deepgraft_tpu_torch.cli import visualize as tcli
from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.models import transmil as ttransmil
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.models.resnet import resnet18
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.train.kfold import run_kfold
from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    backbone_state_dict_from_jax,
    state_dict_from_jax,
)
from transmil_deepgraft_tpu_torch.visualize import cam as tcam
from transmil_deepgraft_tpu_torch.visualize import heatmap as theat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(n: int) -> np.ndarray:
    side = int(np.ceil(np.sqrt(n)))
    return np.stack(np.unravel_index(np.arange(n), (side, side)), 1)[:, ::-1].astype(np.int64)


# ------------------------------------------------------------------ CAMs

@pytest.fixture(scope="module")
def acts_grads():
    r = np.random.default_rng(0)
    a = np.abs(r.standard_normal((3, 4, 5, 16))).astype(np.float32)
    g = r.standard_normal((3, 4, 5, 16)).astype(np.float32)
    return a, g


@pytest.mark.parametrize("method", sorted(jcam.CAM_METHODS))
def test_cam_methods_match_jax(acts_grads, method):
    a, g = acts_grads
    want = np.asarray(jcam.compute_cam(method, jnp.asarray(a), jnp.asarray(g)))
    got = tcam.compute_cam(method, torch.from_numpy(a), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(tcam.normalize_cam(got, per_tile=True),
                               jcam.normalize_cam(want, per_tile=True), atol=1e-5, rtol=0)
    if method == "eigencam":
        np.testing.assert_allclose(tcam.compute_cam(method, torch.from_numpy(a)).numpy(), want,
                                   atol=1e-5, rtol=0)
    else:
        with pytest.raises(ValueError, match="needs grads"):
            tcam.compute_cam(method, torch.from_numpy(a))


def test_score_cam_and_overlay_match_jax(acts_grads):
    a, _ = acts_grads
    r = np.random.default_rng(1)
    tiles = r.random((3, 10, 12, 3)).astype(np.float32)
    w = r.standard_normal((10, 12, 3)).astype(np.float32)
    want = np.asarray(jcam.score_cam(jnp.asarray(a), jnp.asarray(tiles),
                                     lambda t: jnp.sum(t * w), channel_batch=8))
    got = tcam.score_cam(torch.from_numpy(a), torch.from_numpy(tiles),
                         lambda t: (t * torch.from_numpy(w)).sum(), channel_batch=8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="channel_batch"):
        tcam.score_cam(torch.from_numpy(a), torch.from_numpy(tiles), lambda t: t.sum(),
                       channel_batch=5)
    cam = jcam.normalize_cam(want)
    np.testing.assert_array_equal(tcam.normalize_cam(got), jcam.normalize_cam(got))
    np.testing.assert_array_equal(tcam.jet_colormap(cam), jcam.jet_colormap(cam))
    np.testing.assert_array_equal(tcam.show_cam_on_image(tiles[0, :4, :5], cam[0]),
                                  jcam.show_cam_on_image(tiles[0, :4, :5], cam[0]))


# --------------------------------------------------------------- assembly

def test_assembly_and_roi_equal_jax():
    r = np.random.default_rng(2)
    cells = [(x, y) for y in range(6) for x in range(8)]
    coords = np.asarray([cells[i] for i in r.choice(len(cells), 35, replace=False)], np.int64)
    scores = r.random(35).astype(np.float32)
    for kw in ({}, {"downsample": 2, "blur_sigma": 0.5}, {"blur_sigma": 0}):
        np.testing.assert_allclose(theat.assemble_heatmap(coords, scores, **kw),
                                   jheat.assemble_heatmap(coords, scores, **kw), atol=1e-12)
    pix = theat.assemble_pixel_attention_map(coords, scores, tile_px=32, sigma=4.0)
    np.testing.assert_allclose(pix, jheat.assemble_pixel_attention_map(coords, scores, tile_px=32,
                                                                        sigma=4.0), atol=1e-12)
    np.testing.assert_allclose(pix, reference_attention_mask(coords, scores, tile_px=32,
                                                             sigma=4.0), atol=2e-5)
    occupancy = np.zeros((12, 12))
    occupancy[1:7, 1:7] = 1
    occupancy[3, 3] = 0  # a hole
    occupancy[10, 10] = 1  # a speck
    for kw in ({}, {"min_size": 1, "fill_holes": False}):
        np.testing.assert_array_equal(theat.roi_mask(occupancy, **kw),
                                      jheat.roi_mask(occupancy, **kw))


@pytest.mark.parametrize("colormap", ["jet", "viridis"])
def test_heatmap_jpeg_bytes_equal_jax(tmp_path, colormap):
    r = np.random.default_rng(3)
    hm = r.random((9, 13))
    hm[0, 0], hm[0, 1] = 0.0, 1.0
    base = r.integers(0, 255, (40, 50, 3))
    for kw in ({}, {"base_image": base, "alpha": 0.3, "upscale": 4}):
        a = theat.save_heatmap_jpeg(hm, tmp_path / "port.jpg", colormap=colormap, **kw)
        b = jheat.save_heatmap_jpeg(hm, tmp_path / "jax.jpg", colormap=colormap, **kw)
        assert a.read_bytes() == b.read_bytes()


def test_jet_table_is_matplotlibs():
    import matplotlib as mpl

    values = np.linspace(0, 1, 1001)
    np.testing.assert_array_equal(theat.colormap_rgb(values), mpl.colormaps["jet"](values)[:, :3])


def test_nmf_matches_scikit_learn():
    r = np.random.default_rng(4)
    w0, h0 = r.random((120, 4)) + 0.1, r.random((4, 64)) * np.array([[8], [4], [2], [1]])
    feats = w0 @ h0 + 0.01 * r.random((120, 64)) - 0.5
    w, h = theat.deep_feature_factorization(feats, 4)
    jw, jh = jheat.deep_feature_factorization(feats, 4)
    assert w.shape == (120, 4) and h.shape == (4, 64) and (w >= 0).all() and (h >= 0).all()
    assert np.abs(w - jw).max() <= 1e-9 * np.abs(jw).max()
    assert np.abs(h - jh).max() <= 1e-9 * np.abs(jh).max()


# ------------------------------------------------------------- Visualizer

N_TILES, IN_F = 90, 48


@pytest.fixture(scope="module")
def jax_slide(tmp_path_factory):
    r = np.random.default_rng(5)
    bag = r.standard_normal((N_TILES, IN_F)).astype(np.float32)
    coords = _grid(N_TILES)
    model = JaxTransMIL(n_classes=2, in_features=IN_F, out_features=512)
    variables = model.init({"params": jax.random.key(0)}, bag[None])
    out = tmp_path_factory.mktemp("jax_viz")
    result = jheat.Visualizer(model, variables, out, target_class=1).run_slide(bag, coords, "s0")
    return bag, coords, jax.device_get(variables["params"]), result, out


def _port_transmil(params, in_f: int, width: int, **kw):
    model = create_model("TransMIL", 2, in_f, width, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params, in_f))
    return model


def _topk(path: Path) -> pd.DataFrame:
    return pd.read_csv(path)


def _same_topk(got: Path, want: Path) -> None:
    a, b = _topk(got), _topk(want)
    assert list(a.columns) == list(b.columns) == ["slide", "rank", "x", "y", "score"]
    assert a[["slide", "rank", "x", "y"]].equals(b[["slide", "rank", "x", "y"]])
    np.testing.assert_allclose(a["score"], b["score"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["layers", "landmark_kernels"])
def test_visualizer_matches_jax(jax_slide, tmp_path, use_pallas):
    bag, coords, params, want, jout = jax_slide
    model = _port_transmil(params, IN_F, 512, use_pallas=use_pallas)
    got = theat.Visualizer(model, tmp_path, target_class=1).run_slide(bag, coords, "s0")
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["attention"], want["attention"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["gradcam"], want["gradcam"], atol=1e-3, rtol=0)
    assert [p.name for p in got["paths"]] == [p.name for p in want["paths"]]
    assert all(p.stat().st_size > 0 for p in got["paths"])
    _same_topk(tmp_path / "s0_topk_tiles.csv", jout / "s0_topk_tiles.csv")


def test_gradcam_takes_the_standard_layers(jax_slide, monkeypatch):
    """The fused TransLayer route has no backward on the card (K1/K2): a
    forward that takes a gradient runs the standard layers, and the eval
    forwards under inference_mode still take the fused route."""
    bag, _, params, _, _ = jax_slide
    model = _port_transmil(params, IN_F, 512).eval()
    calls = []
    real = ttransmil.fused_translayer
    monkeypatch.setattr(ttransmil, "fused_translayer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(bag[None])
    cam = theat.gradcam_tile_scores(model, x, 1)
    assert calls == [] and cam.shape == (N_TILES,) and cam.max() == pytest.approx(1.0)
    with torch.inference_mode():
        fused = model(x)
    assert calls == [1, 1]
    with torch.no_grad():
        model(x)
    assert len(calls) == 4
    with torch.enable_grad():
        layers = model(x)
    assert len(calls) == 4 and layers.grad_fn is not None
    np.testing.assert_allclose(layers.detach().numpy(), fused.numpy(), atol=1e-4, rtol=0)


def test_image_visualizer_matches_jax(tmp_path):
    r = np.random.default_rng(6)
    tiles = r.standard_normal((6, 48, 48, 3)).astype(np.float32)
    coords = np.array([[0, 0], [1, 0], [2, 0], [0, 1], [1, 1], [2, 1]])
    backbone, head = jresnet18(), JaxTransMIL(n_classes=2, in_features=512, out_features=32)
    bvars = jax.jit(backbone.init)({"params": jax.random.key(0)}, jnp.asarray(tiles))
    hvars = jax.jit(head.init)({"params": jax.random.key(1)}, jnp.ones((1, 6, 512), jnp.float32))
    tb = resnet18(num_classes=0)
    tb.load_state_dict(backbone_state_dict_from_jax(jax.device_get(bvars)))
    th = _port_transmil(jax.device_get(hvars["params"]), 512, 32)
    want = jheat.ImageVisualizer(backbone, head, bvars, hvars, tmp_path / "jax", chunk=4,
                                 tile_size=48).run_slide(tiles, coords, "slideX")
    got = theat.ImageVisualizer(tb, th, tmp_path / "port", chunk=4,
                                tile_size=48).run_slide(tiles, coords, "slideX")
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["attention"], want["attention"], atol=1e-4, rtol=0)
    assert got["pixel_cams"].shape == want["pixel_cams"].shape == (6, 2, 2)
    np.testing.assert_allclose(got["pixel_cams"], want["pixel_cams"], atol=1e-4, rtol=0)
    assert [p.name for p in got["paths"]] == [p.name for p in want["paths"]]
    _same_topk(tmp_path / "port" / "slideX_topk_tiles.csv",
               tmp_path / "jax" / "slideX_topk_tiles.csv")


# ----------------------------------------------------------- cli.visualize

CONFIG = {
    "General": {"seed": 2021, "precision": 32, "epochs": 1, "grad_acc": 1, "patience": 10,
                "server": "train", "log_path": "logs/"},
    "Data": {"dataset_name": "custom", "fold": 0, "nfold": 2, "cross_val": False,
             "train_dataloader": {"batch_size": 1}, "test_dataloader": {"batch_size": 1},
             "bag_size": 40, "mixup": False},
    "Model": {"name": "TransMIL", "n_classes": 2, "backbone": "features", "in_features": IN_F,
              "out_features": 64},
    "Optimizer": {"opt": "radam", "lr": 1e-3, "weight_decay": 0.01},
    "Loss": {"base_loss": "CrossEntropyLoss"},
}


def test_visualize_cli_matches_jax(tmp_path, capsys):
    import h5py

    r = np.random.default_rng(7)
    data = tmp_path / "data" / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels = {}
    for split, n in (("train", 2), ("val", 2), ("test", 3)):
        labels[split] = []
        for i in range(n):
            name = f"{split}_{i}"
            with h5py.File(data / f"{name}.h5", "w") as f:
                f["features"] = r.standard_normal((40, IN_F)).astype(np.float32)
                f["coords"] = _grid(40)[r.permutation(40)]
            labels[split].append([f"FEATURES_RETCCL_2048/{name}.h5", i % 2])
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    cfg = json.loads(json.dumps(CONFIG))
    cfg["Data"].update(data_dir=str(tmp_path / "data"), label_file=str(tmp_path / "labels.json"))
    config = tmp_path / "DeepGraft" / "TransMIL_feat_norm_rest.yaml"
    config.parent.mkdir()
    config.write_text(yaml.safe_dump(cfg))
    params = JaxTransMIL(2, IN_F, 64).init({"params": jax.random.key(3)},
                                          jnp.zeros((1, 40, IN_F), jnp.float32))["params"]
    save_pytree(tmp_path / "weights.ckpt", {"params": jax.device_get(params)})
    argv = ["--config", str(config), "--ckpt", str(tmp_path / "weights.ckpt"), "--max_slides",
            "2"]
    want = jcli.main(argv + ["--log_dir", str(tmp_path / "jax_log"),
                             "--out_dir", str(tmp_path / "jax")])
    got = tcli.main(argv + ["--log_dir", str(tmp_path / "port_log"),
                            "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "slides": 2, "out_dir": str(tmp_path / "port")}
    index = json.loads((tmp_path / "port" / "heatmap_index.json").read_text())
    assert index == got and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["slide"], g["patient"], g["label"]) == (w["slide"], w["patient"], w["label"])
        np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-4, rtol=0)
        assert [Path(p).name for p in g["paths"]] == [Path(p).name for p in w["paths"]]
        _same_topk(tmp_path / "port" / f"{g['slide']}_topk_tiles.csv",
                   tmp_path / "jax" / f"{g['slide']}_topk_tiles.csv")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


# ---------------------------------------------------------------- Trainer

SYNTH = {"n_train": 6, "n_val": 4, "n_test": 4, "bag_size": 48, "feature_size": 32,
         "signal": 2.0}


def test_figures_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    from transmil_deepgraft_tpu_torch.utils import plots

    def missing():
        raise ImportError("figures need matplotlib, which is not installed")

    monkeypatch.setattr(plots, "pyplot", missing)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_model("TransMIL", 2, 32, 32, device="cpu")
    ttr = Trainer(model, create_optimizer("adam", lr=1e-3),
                  MILDataModule(n_classes=2, max_bag_size=48, batch_size=2, synthetic=SYNTH, seed=0),
                  n_classes=2, loss_fn=tlosses.create_loss(),
                  config=TrainerConfig(epochs=1, log_dir=str(tmp_path / "port"), task="norm_rest"))
    ttr.fit()
    ttr.test()
    out = capsys.readouterr().out
    assert "[trainer] epoch figure export skipped: figures need matplotlib" in out
    assert "[trainer] figure export skipped: figures need matplotlib" in out
    assert not list((tmp_path / "port").rglob("*.png"))
    assert len(list((tmp_path / "port" / "topk_tiles").glob("*.csv"))) == SYNTH["n_test"]


def test_trainer_and_kfold_write_jax_topk_tiles_and_figures(tmp_path):
    """Both packages' k-fold runs from the same initial weights (each fold
    starts from them, dropout off, 1 epoch): the fold test stages' and the
    ensemble's mean-attention top-k tiles are JAX's, and so are the files
    of the epoch and test figures."""
    from transmil_deepgraft_tpu.train.kfold import run_kfold as jax_run_kfold

    jmodel = JaxTransMIL(n_classes=2, in_features=32, out_features=32)
    params = jax.device_get(jmodel.init({"params": jax.random.key(0)},
                                        jnp.zeros((1, 48, 32), jnp.float32))["params"])
    config = dict(epochs=1, patience=5, task="norm_rest", train_deterministic=True)

    def jax_build(fold_dm, log_dir):
        tr = JaxTrainer(jmodel, jax_create_optimizer(opt="adam", lr=1e-3), fold_dm,
                        n_classes=2, loss_fn=jlosses.create_loss(),
                        config=JaxTrainerConfig(log_dir=log_dir, **config))
        tr.params = jax.tree.map(jnp.asarray, params)
        tr.opt_state = tr.tx.init(params)
        return tr

    def port_build(fold_dm, log_dir):
        return Trainer(_port_transmil(params, 32, 32), create_optimizer("adam", lr=1e-3),
                       fold_dm, n_classes=2, loss_fn=tlosses.create_loss(),
                       config=TrainerConfig(log_dir=log_dir, **config))

    jax_run_kfold(jax_build, JaxDataModule(n_classes=2, max_bag_size=48, batch_size=2,
                                           synthetic=SYNTH, seed=0), 2, tmp_path / "jax")
    run_kfold(port_build, MILDataModule(n_classes=2, max_bag_size=48, batch_size=2,
                                        synthetic=SYNTH, seed=0), 2, tmp_path / "port")
    for sub in ("ensemble_topk_tiles", "fold0/topk_tiles", "fold1/topk_tiles"):
        want = sorted((tmp_path / "jax" / sub).glob("*_topk_tiles.csv"))
        got = sorted((tmp_path / "port" / sub).glob("*_topk_tiles.csv"))
        assert [p.name for p in got] == [p.name for p in want] and len(got) == SYNTH["n_test"]
        for g, w in zip(got, want):
            _same_topk(g, w)

    def figures(root: Path) -> list[str]:
        return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                      if p.suffix in (".png", ".svg"))

    assert figures(tmp_path / "port") == figures(tmp_path / "jax")
    assert {"fold0/figures/val_patient_roc_epoch000.png",
            "fold1/test_patient_confusion.svg"} <= set(figures(tmp_path / "port"))
