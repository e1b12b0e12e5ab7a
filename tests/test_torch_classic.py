"""The classic per-tile pipeline and the new backbones through the port's
CLIs, against the JAX package, on the CPU.

- one train step of the classic tile classifier over 'simple' and 'vit'
  (the two JAX trains): logits within 1e-3, loss within 1e-5, gradients
  within 1e-4 of the largest of each tensor;
- over the BatchNorm networks (resnet18, efficientnet, inception) JAX's
  Trainer cannot train (its apply does not let the statistics move, ROADMAP
  C6); the port's resnet18 train step is JAX's ``apply(...,
  mutable=["batch_stats"])`` (float64 on both sides): logits and gradients
  within 1e-4, the moved statistics within 1e-5;
- the seven classic configs as written raise JAX's KeyError in both CLIs
  (ROADMAP C13);
- ``cli.train --fast_dev_run`` of the ``tiles`` variant (a narrow ViT;
  ``Model.name`` a bag head, as JAX's route needs) against JAX's from JAX's
  initial weights: loss and val_loss within 1e-4, the tile -> slide ->
  patient result CSVs within 1e-4;
- ``cli.extract_features --backbone vit`` against JAX's ``.h5`` files
  (features within 1e-5 of the largest), and ``--backbone dino --ckpt`` a
  DINO-named .pth against the torch reference module (JAX's CLI converts
  every checkpoint as a ResNet and fails, ROADMAP C15);
- ``cli.train`` of an ``images`` YAML over a narrow ViT with DINO .pth
  weights into TransMIL, against JAX's: loss and val_loss within 1e-4, AUCs
  within 0.005.

The ViTs are narrow (dim 64, depth 1 or 2): both packages' ``create_backbone``
is patched to build them, the rest of each route is the CLI's own.
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests.torch_ref.backbones_torch import DinoViT
from transmil_deepgraft_tpu.cli import extract_features as jcli_extract
from transmil_deepgraft_tpu.cli import train as jcli_train
from transmil_deepgraft_tpu.data import feature_extractor as jfe
from transmil_deepgraft_tpu.data import native_tiles as jnt
from transmil_deepgraft_tpu.models import backbones as jbb
from transmil_deepgraft_tpu.models import classic as jclassic
from transmil_deepgraft_tpu.models import vit as jvit
from transmil_deepgraft_tpu.train import losses as jlosses
from transmil_deepgraft_tpu_torch.cli import extract_features as tcli_extract
from transmil_deepgraft_tpu_torch.cli import train as tcli_train
from transmil_deepgraft_tpu_torch.data import feature_extractor as tfe
from transmil_deepgraft_tpu_torch.data import native_tiles as tnt
from transmil_deepgraft_tpu_torch.data.jpg_bags import JPGMILDataset
from transmil_deepgraft_tpu_torch import models as tmodels
from transmil_deepgraft_tpu_torch.models import backbones as tbb
from transmil_deepgraft_tpu_torch.models import classic as tclassic
from transmil_deepgraft_tpu_torch.models import create_classic_model
from transmil_deepgraft_tpu_torch.models import vit as tvit
from transmil_deepgraft_tpu_torch.train import losses as tlosses
from transmil_deepgraft_tpu_torch.utils import h5
from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    backbone_state_dict_from_jax,
    classic_state_dict_from_jax,
    classic_variables_from_module,
    head_state_dict_from_jax,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "transmil_deepgraft_tpu" / "configs" / "DeepGraft"
CLASSIC_CONFIGS = ("Vit_classic_norm_rest.yaml", "Vit_classic_rej_rest.yaml",
                   "Vit_classic_norm_rej_rest.yaml", "Resnet18_classic_norm_rest.yaml",
                   "Resnet18_classic_rej_rest.yaml", "EfficientNet_classic_norm_rest.yaml",
                   "Inception_norm_rest.yaml")
NARROW_VIT = {"patch_size": 16, "dim": 64, "depth": 2, "heads": 2, "img_size": 32}
_ORIG_JAX_CREATE = jbb.create_backbone
_ORIG_PORT_CREATE = tbb.create_backbone
_ORIG_JAX_TRAIN_BUILD = jcli_train.build
_ORIG_PORT_TRAIN_BUILD = tcli_train.build
_ORIG_JAX_EXTRACT = jfe.extract_cohort


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow_backbones(monkeypatch, vit: dict = NARROW_VIT, simple_out: int = 16) -> None:
    """Both packages' create_backbone build a narrow ViT for 'vit'/'dino'
    and a narrow-fc simple CNN; every other name as it is."""

    def jax_create(name, out_features=512):
        if name in ("vit", "dino"):
            return jvit.VisionTransformer(**vit), vit["dim"]
        if name == "simple":
            return jbb.SimpleCNN(out_features=simple_out), simple_out
        return _ORIG_JAX_CREATE(name, out_features)

    def port_create(name, out_features=512):
        if name in ("vit", "dino"):
            return tvit.VisionTransformer(**vit), vit["dim"]
        if name == "simple":
            return tbb.SimpleCNN(out_features=simple_out), simple_out
        return _ORIG_PORT_CREATE(name, out_features)

    monkeypatch.setattr(jbb, "create_backbone", jax_create)
    for module in (tbb, tmodels, tclassic):
        monkeypatch.setattr(module, "create_backbone", port_create)


def _x(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_step(jmodel, variables, x, labels, n_classes, mutable=False):
    """JAX's train-step loss and gradients (the Trainer's loss_of), and with
    ``mutable`` the moved batch_stats."""
    loss_fn = jlosses.create_loss("CrossEntropyLoss", n_classes)

    def loss_of(params):
        out = jmodel.apply({**variables, "params": params}, x, deterministic=False,
                           mutable=["batch_stats"] if mutable else False)
        logits, state = out if mutable else (out, None)
        return loss_fn(logits, jax.nn.one_hot(labels, n_classes)), (logits, state)

    (loss, (logits, state)), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])
    return jax.device_get((loss, logits, grads, state))


def _port_step(model, x, labels, n_classes, dtype=torch.float32):
    """The port Trainer's train forward (train mode, soft-target CE) and
    backward: (loss, logits, gradients as a flax tree)."""
    model.train()
    logits = model(torch.from_numpy(x).to(dtype))
    loss = tlosses.create_loss()(logits, torch.nn.functional.one_hot(
        torch.from_numpy(labels).long(), n_classes).to(dtype))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(grads[n])
    tree = classic_variables_from_module(model)["params"]
    model.zero_grad()
    return loss.item(), logits.detach().numpy(), tree


def _close_trees(got, want, rel: float) -> None:
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(flat[path])
        np.testing.assert_allclose(leaf, w, atol=rel * max(np.abs(w).max(), 1e-6), rtol=0,
                                   err_msg=str(path))


# ---------------------------------------------------------- train steps

@pytest.mark.parametrize("name, size", [("simple", 224), ("vit", 32)])
def test_classic_train_step_matches_jax(monkeypatch, name, size):
    """The classic classifier's train step (a (2, 3)-tile bag, flattened to
    its 6 tiles) in both packages from the same weights."""
    _narrow_backbones(monkeypatch)
    x = _x((2, 3, size, size, 3), 1)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        model = create_classic_model(name, 2, "cpu")
    variables = classic_variables_from_module(model)
    del variables["batch_stats"]
    jmodel = jclassic.classic_model(name, 2)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x)))
    assert jax.tree.map(np.shape, variables) == jax.tree.map(lambda s: s.shape, dict(shapes))
    loss, logits, grads, _ = _jax_step(jmodel, variables, x, labels, 2)
    tloss, tlogits, tgrads = _port_step(model, x, labels, 2)
    np.testing.assert_allclose(tlogits, logits, atol=1e-3, rtol=0)
    assert abs(tloss - float(loss)) <= 1e-5
    _close_trees(tgrads, grads, 1e-4)


@pytest.mark.parametrize("name, size", [("resnet18", 32), ("efficientnet", 32),
                                        ("inception", 75)])
def test_classic_batchnorm_step_is_jax_mutable_step(name, size):
    """JAX's Trainer applies the model with its statistics immutable, which
    a train-mode BatchNorm refuses (C6); the port trains with flax's rule:
    its step is JAX's with ``mutable=["batch_stats"]``, in float64."""
    x = _x((4, size, size, 3), 3)
    labels = np.array([0, 1, 1, 0], np.int32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = create_classic_model(name, 2, "cpu")
    jmodel = jclassic.classic_model(name, 2)
    variables = classic_variables_from_module(model)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x)))
    assert jax.tree.map(np.shape, variables) == jax.tree.map(lambda s: s.shape, dict(shapes))
    back = classic_state_dict_from_jax(variables, model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items()
               if not k.endswith("batches_tracked"))
    with pytest.raises(Exception, match="batch_stats.*immutable"):
        jmodel.apply(variables, jnp.asarray(x), deterministic=False)
    if name != "resnet18":  # the same BatchNorm2d (held in test_torch_backbones.py)
        return
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        loss, logits, grads, state = _jax_step(jmodel, v64, x.astype(np.float64), labels, 2,
                                               mutable=True)
    tloss, tlogits, tgrads = _port_step(model.double(), x, labels, 2, torch.float64)
    np.testing.assert_allclose(tlogits, logits, atol=1e-4, rtol=0)
    assert abs(tloss - float(loss)) <= 1e-5
    _close_trees(tgrads, grads, 1e-4)
    moved = classic_variables_from_module(model)["batch_stats"]
    _close_trees(moved, state["batch_stats"], 1e-5)
    assert any(np.abs(a - b).max() > 1e-4 for a, b in zip(
        jax.tree.leaves(variables["batch_stats"]), jax.tree.leaves(moved)))


# ------------------------------------------------------------- configs

def _write_yaml(root: Path, name: str, cfg: dict) -> Path:
    path = root / "DeepGraft" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("config", CLASSIC_CONFIGS)
def test_classic_configs_raise_jax_keyerror(tmp_path, config):
    """ROADMAP C13: a classic config names its network in Model.name, which
    no registry holds; JAX's cli.train raises KeyError before any data
    loads, and so does the port's."""
    cfg = yaml.safe_load((CONFIGS / config).read_text())
    cfg["Data"].update(data_dir=str(tmp_path / "none"), label_file=str(tmp_path / "l.json"))
    path = _write_yaml(tmp_path, config, cfg)
    name = cfg["Model"]["name"]
    with pytest.raises(KeyError, match=f"unknown model '{name}'"):
        jcli_train.main(["--config", str(path), "--log_dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match=f"unknown model '{name}'.*ROADMAP C13"):
        tcli_train.main(["--config", str(path), "--log_dir", str(tmp_path / "port"),
                         "--device", "cpu"])


# ---------------------------------------------------------- cli.train

def _tile_cohort(root: Path, size: int, splits=(("train", 4), ("val", 2), ("test", 2)),
                 tiles: int = 3) -> Path:
    """BLOCKS/<slide>/*.jpg for each split, a label JSON; returns it."""
    r = np.random.default_rng(9)
    labels = {}
    for split, n in splits:
        labels[split] = []
        for i in range(n):
            name = f"{split}_{i}"
            folder = root / "data" / "BLOCKS" / name
            folder.mkdir(parents=True)
            for t in range(tiles):
                img = (r.integers(0, 200, (size, size, 3)) + 50 * (i % 2)).astype(np.uint8)
                Image.fromarray(img).save(folder / f"t_({t}-{i}).jpg", quality=95)
            labels[split].append([name, i % 2])
    (root / "labels.json").write_text(json.dumps(labels))
    return root / "labels.json"


def _config(root: Path, name: str, data: dict, model: dict, batch: int) -> Path:
    return _write_yaml(root, name, {
        "General": {"seed": 2021, "precision": 32, "epochs": 1, "grad_acc": 1, "patience": 5,
                    "log_path": str(root / "logs")},
        "Data": {"dataset_name": "custom", "train_dataloader": {"batch_size": batch},
                 "test_dataloader": {"batch_size": 1}, **data},
        "Model": {"n_classes": 2, **model},
        "Optimizer": {"opt": "Adam", "lr": 2e-4, "weight_decay": 0.01},
        "Loss": {"base_loss": "CrossEntropyLoss"},
    })


def _rows(log_dir: Path) -> list[dict]:
    lines = (log_dir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "val_loss" in r]


def _run_both(monkeypatch, tmp_path, config: Path, load_initial) -> tuple[dict, dict, object]:
    """Both CLIs on one YAML with --fast_dev_run: JAX's from key(seed), the
    port's from JAX's initial weights (``load_initial(port trainer,
    JAX params)``); returns (JAX's summary, the port's, JAX's trainer)."""
    initial, trainers = {}, {}

    def jax_build(cfg, log_dir=None):
        t = _ORIG_JAX_TRAIN_BUILD(cfg, log_dir)
        t.cfg.train_deterministic = True
        t.cfg.epoch_figures = False
        t.cfg.export_topk_tiles = False
        object.__setattr__(t.model, "init", jax.jit(t.model.init))
        init_params = t.init_params

        def keep_initial(batch):
            init_params(batch)
            initial.update(jax.device_get(t.params))

        t.init_params = keep_initial
        trainers["jax"] = t
        return t

    def port_build(cfg, log_dir=None, device=None):
        t = _ORIG_PORT_TRAIN_BUILD(cfg, log_dir, device)
        t.cfg.train_deterministic = True
        load_initial(t, initial)
        return t

    monkeypatch.setattr(jcli_train, "build", jax_build)
    monkeypatch.setattr(tcli_train, "build", port_build)
    jax_summary = jcli_train.main(["--config", str(config), "--log_dir", str(tmp_path / "jax"),
                                   "--fast_dev_run"])
    summary = tcli_train.main(["--config", str(config), "--log_dir", str(tmp_path / "port"),
                               "--fast_dev_run", "--device", "cpu"])
    (jr,), (tr,) = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert abs(jr["loss"] - tr["loss"]) <= 1e-4 and abs(jr["val_loss"] - tr["val_loss"]) <= 1e-4
    return jax_summary, summary, trainers["jax"]


def _csv_rows(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_cli_train_tiles_matches_jax(tmp_path, monkeypatch):
    """The tiles variant (Model.name AttMIL, Model.backbone vit, 32-px
    tiles, a train batch of 4 tiles): the classic classifier from JAX's
    initial weights; one step, then tile-level val and test. The result
    CSVs (tiles -> slides -> patients) within 1e-4 of JAX's."""
    _narrow_backbones(monkeypatch)
    labels = _tile_cohort(tmp_path, 32)
    config = _config(tmp_path, "AttMIL_vit_tiles_norm_rest.yaml",
                     {"data_dir": str(tmp_path / "data"), "label_file": str(labels),
                      "variant": "tiles", "tile_size": 32, "mixup": True},
                     {"name": "AttMIL", "backbone": "vit"}, batch=4)

    def load_initial(t, params):
        assert t.cfg.tile_level and t.dm.variant == "tiles" and t.dm.eval_pad == "exact"
        t.model.load_state_dict(classic_state_dict_from_jax({"params": params}, t.model))

    _, _, jt = _run_both(monkeypatch, tmp_path, config, load_initial)
    # JAX's last.ckpt (weights, Adam state, counters) resumes in the port
    t = _ORIG_PORT_TRAIN_BUILD(finalize_config(read_yaml(config), config_path=config),
                               str(tmp_path / "resume"), "cpu")
    assert t.load_train_state(tmp_path / "jax" / "checkpoints" / "last.ckpt")
    want = classic_state_dict_from_jax({"params": jax.device_get(jt.params)}, t.model)
    assert all(torch.equal(v, want[k]) for k, v in t.model.state_dict().items())
    assert t.tx.state_dict()["count"] == 1
    for name in ("TEST_RESULT_PATIENT.csv", "TEST_RESULT_SLIDE.csv"):
        want, got = _csv_rows(tmp_path / "jax" / name), _csv_rows(tmp_path / "port" / name)
        assert len(got) == len(want) > 0 and list(got[0]) == list(want[0])
        for w, g in zip(want, got):
            for key, value in w.items():
                try:
                    assert abs(float(g[key]) - float(value)) <= 1e-4, (name, key)
                except ValueError:
                    assert g[key] == value, (name, key)


def test_cli_train_images_vit_matches_jax(tmp_path, monkeypatch):
    """The images variant: TransMIL-64 behind a narrow ViT (dim 64) whose
    weights are a DINO-named .pth, both CLIs from JAX's initial head; loss
    and val_loss within 1e-4, AUCs within 0.005."""
    _narrow_backbones(monkeypatch, {**NARROW_VIT, "depth": 1})
    labels = _tile_cohort(tmp_path, 32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        torch.save(DinoViT(img_size=32, patch=16, dim=64, depth=1, heads=2).state_dict(),
                   tmp_path / "dino.pth")
    config = _config(tmp_path, "TransMIL_dino_norm_rest.yaml",
                     {"data_dir": str(tmp_path / "data"), "label_file": str(labels),
                      "variant": "images", "tile_size": 32, "bag_size": 3},
                     {"name": "TransMIL", "backbone": "dino", "in_features": 768,
                      "backbone_weights": str(tmp_path / "dino.pth")}, batch=2)

    def load_initial(t, params):
        assert t.model.head._fc1[0].in_features == 64  # rebuilt for the backbone's width
        t.model.head.load_state_dict(head_state_dict_from_jax("TransMIL", params["head"], 64))
        own = t.model.backbone.state_dict()
        carried = backbone_state_dict_from_jax({"params": params["backbone"]})
        assert all(torch.equal(own[k], v) for k, v in carried.items())  # the .pth in both

    jax_summary, summary, _ = _run_both(monkeypatch, tmp_path, config, load_initial)
    for key in ("test_auc", "test_patient_auc"):
        assert abs(summary[key] - jax_summary[key]) <= 0.005, key
    assert abs(summary["test_loss"] - jax_summary["test_loss"]) <= 1e-4


# -------------------------------------------------------- extraction

def test_cli_extract_features_vit_matches_jax(tmp_path, monkeypatch):
    """--backbone vit (tiles resized to 224, a batch of 4): the port from
    JAX's key(0) weights writes JAX's .h5 files within 1e-5 of the largest
    feature. --backbone dino --ckpt a DINO-named .pth: the port's features
    are the torch reference module's; JAX's CLI converts the .pth as a
    ResNet and fails (ROADMAP C15)."""
    vit = {"patch_size": 16, "dim": 64, "depth": 1, "heads": 2, "img_size": 224}
    _narrow_backbones(monkeypatch, vit)
    monkeypatch.setattr(jnt, "available", lambda: False)
    monkeypatch.setattr(tnt, "available", lambda: False)
    labels = _tile_cohort(tmp_path, 48, splits=(("test", 2),), tiles=3)
    captured = {}

    def capture(backbone, variables, *args, **kw):
        captured.update(jax.device_get(variables))
        return _ORIG_JAX_EXTRACT(backbone, variables, *args, **kw)

    monkeypatch.setattr(jfe, "extract_cohort", capture)
    jax_create = jbb.create_backbone
    monkeypatch.setattr(jbb, "create_backbone", lambda name, **kw: (
        _jitted(jax_create(name, **kw)[0]), jax_create(name, **kw)[1]))
    argv = ["--data_dir", str(tmp_path / "data"), "--label_file", str(labels),
            "--batch_size", "4"]
    jfiles = jcli_extract.main([*argv, "--backbone", "vit", "--out_dir", str(tmp_path / "jax")])

    port_create = tbb.create_backbone

    def port_with_jax_weights(name, **kw):
        module, dim = port_create(name, **kw)
        module.load_state_dict(backbone_state_dict_from_jax(captured))
        return module, dim

    monkeypatch.setattr(tbb, "create_backbone", port_with_jax_weights)
    tfiles = tcli_extract.main([*argv, "--backbone", "vit", "--out_dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert [Path(p).name for p in tfiles] == [Path(p).name for p in jfiles] == [
        "test_0.h5", "test_1.h5"]
    for jp, tp in zip(jfiles, tfiles):
        want, got = h5.read(jp), h5.read(tp)
        assert got["features"].shape == want["features"].shape == (3, 64)
        np.testing.assert_allclose(got["features"], want["features"],
                                   atol=1e-5 * np.abs(want["features"]).max(), rtol=0)
        assert got["coords"].tobytes() == want["coords"].tobytes()

    monkeypatch.setattr(tbb, "create_backbone", port_create)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        ref = DinoViT(img_size=224, patch=16, dim=64, depth=1, heads=2).eval()
    torch.save(ref.state_dict(), tmp_path / "dino.pth")
    ckpt = ["--backbone", "dino", "--ckpt", str(tmp_path / "dino.pth")]
    with pytest.raises(Exception, match="collection is empty"):  # its params replaced by {}
        jcli_extract.main([*argv, *ckpt, "--out_dir", str(tmp_path / "jax_ckpt")])
    tcli_extract.main([*argv, *ckpt, "--out_dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    ds = JPGMILDataset(tmp_path / "data", labels, "test", 2)
    tiles = tfe.decode_batch(ds.tiles_of(0), 224, False, None)  # the CLI's PIL route
    with torch.no_grad():
        want = ref(torch.from_numpy(tiles).permute(0, 3, 1, 2)).numpy()
    got = h5.read(tmp_path / "ckpt" / "test_0.h5")["features"]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _jitted(module):
    object.__setattr__(module, "init", jax.jit(module.init))
    return module
