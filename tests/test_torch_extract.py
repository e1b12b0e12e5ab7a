"""The port's extraction front end and image-bag models against the JAX
package's, on the CPU.

- the tile backbones (RetCCL ResNet50, the CLAM baseline, ResNet18 behind
  its projection, the simple CNN) with the flax variables carried across:
  features within 1e-5 relative to the largest one, and the weights carried
  back (``variables_from_module``) equal;
- ``ImageMILModel`` (chunked frozen backbone -> head) with AttMIL and
  TransMIL heads: logits within 1e-5 and 1e-3;
- ``extract_cohort``: the float32 route's ``.h5`` files (an augmented copy
  included) within 1e-5 of JAX's, which the port's ``FeatureBagDataset``
  reads back; the int8 and int8_fused routes code for code with JAX's
  ``apply_qresnet50`` once JAX's calibrated constants are carried across;
- ``cli.extract_features --bagstore`` against JAX's CLI from one .pth;
- ``cli.train --fast_dev_run`` of an ``images`` YAML against JAX's: loss
  and val_loss within 1e-4, AUCs within 0.005, and the frozen backbone's
  conv kernels moved by coupled L2 weight decay in both (ROADMAP C11).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from chip_smoke import torchvision_state_dict
from tests.test_torch_resnet import perturbed_resnet_variables
from tests.test_torch_resnet_int8 import half_code_share
from transmil_deepgraft_tpu.cli import extract_features as jcli_extract
from transmil_deepgraft_tpu.cli import train as jcli_train
from transmil_deepgraft_tpu.data import feature_extractor as jfe
from transmil_deepgraft_tpu.data import native_tiles as jnt
from transmil_deepgraft_tpu.data.bagstore import BagStore as JaxBagStore
from transmil_deepgraft_tpu.data.jpg_bags import JPGMILDataset as JaxJPG
from transmil_deepgraft_tpu.models import backbones as jbb
from transmil_deepgraft_tpu.models import create_model as jcreate_model
from transmil_deepgraft_tpu.models import resnet_int8 as jq
from transmil_deepgraft_tpu_torch.cli import extract_features as tcli_extract
from transmil_deepgraft_tpu_torch.cli import train as tcli_train
from transmil_deepgraft_tpu_torch.data import feature_extractor as tfe
from transmil_deepgraft_tpu_torch.data import native_tiles as tnt
from transmil_deepgraft_tpu_torch.data.bagstore import BagStore
from transmil_deepgraft_tpu_torch.data.feature_bags import FeatureBagDataset
from transmil_deepgraft_tpu_torch.data.jpg_bags import JPGMILDataset
from transmil_deepgraft_tpu_torch.models import backbones as tbb
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.models import resnet_int8 as tq
from transmil_deepgraft_tpu_torch.utils import h5
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    backbone_state_dict_from_jax,
    head_state_dict_from_jax,
    qresnet_from_jax,
    variables_from_module,
)

SIZE = 64
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel=REL_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def _perturbed(variables: dict, seed: int) -> dict:
    """Non-trivial BatchNorm statistics, so that eval-mode BN matters."""
    r = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (v + 0.05 * r.standard_normal(v.shape).astype(np.float32) if k == "mean" else
                 v * (1 + 0.1 * r.random(v.shape).astype(np.float32)) if k == "var" else v)
                for k, v in tree.items()}

    return {**variables, "batch_stats": walk(variables.get("batch_stats", {}))}


def _jitted_init(module):
    """A flax module whose ``init`` runs as one jitted program (the JAX CLIs
    initialize op by op, which compiles every op on the CPU)."""
    object.__setattr__(module, "init", jax.jit(module.init))
    return module


@pytest.fixture(scope="module")
def resnet_vars():
    return perturbed_resnet_variables(7)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """3 slides of 6, 3 and 5 JPEG tiles (64x64, (x-y) names) in BLOCKS/,
    all in the label JSON's 'test' split."""
    root = tmp_path_factory.mktemp("tiles")
    r = np.random.default_rng(0)
    entries = []
    for i, n in enumerate((6, 3, 5)):
        folder = root / "BLOCKS" / f"slide_{i}"
        folder.mkdir(parents=True)
        for t in range(n):
            img = r.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(img).save(folder / f"tile_({t}-{i}).jpg", quality=90)
        entries.append([f"slide_{i}", i % 2])
    (root / "labels.json").write_text(json.dumps({"test": entries, "train": entries,
                                                  "cli": entries[1:2]}))
    return root


# ------------------------------------------------------------ backbones

@pytest.mark.parametrize("name", ["retccl", "resnet50", "resnet18", "simple"])
def test_backbones_match_jax(name, resnet_vars):
    """Features of each backbone within 1e-5 (relative to the largest) of
    the flax module's, and the weights carried back exactly."""
    if name == "simple":  # 224x224 tiles, a narrow fc
        jmodel, tmodel, size = jbb.SimpleCNN(out_features=16), tbb.SimpleCNN(out_features=16), 224
    else:
        jmodel, _ = jbb.create_backbone(name, out_features=16)
        tmodel, _ = tbb.create_backbone(name, out_features=16)
        size = SIZE
    x = np.random.default_rng(1).standard_normal((3, size, size, 3)).astype(np.float32)
    if name in ("retccl", "resnet50"):
        variables = resnet_vars
    else:
        init = jax.jit(lambda k: jmodel.init({"params": k}, jnp.zeros((1, size, size, 3))))
        variables = _perturbed(jax.device_get(init(jax.random.key(3))), 3)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    own = tmodel.state_dict()
    tmodel.load_state_dict({k: v for k, v in backbone_state_dict_from_jax(variables).items()
                            if k in own})
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    _close(got, want)
    back = jax.tree_util.tree_leaves_with_path(variables_from_module(tmodel))
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert back and all(np.array_equal(leaf, flat[path]) for path, leaf in back)


@pytest.mark.parametrize("head, tol", [("AttMIL", 1e-5), ("TransMIL", 1e-3)])
def test_image_mil_model_matches_jax(head, tol):
    """(2 bags x 5 tiles) of 32x32 tiles through ResNet18 + its projection in
    3 chunks (2 zero tiles pad the last) into the head, against JAX's
    ImageMILModel; in train mode the backbone stays in eval mode and gets
    no gradient."""
    dim = 64
    x = np.random.default_rng(2).standard_normal((2, 5, 32, 32, 3)).astype(np.float32)
    jbackbone, _ = jbb.create_backbone("resnet18", out_features=dim)
    jmodel = jbb.ImageMILModel(backbone=jbackbone, head=jcreate_model(head, 2, dim, dim),
                               n_chunks=3)
    v = jax.device_get(jax.jit(jmodel.init)({"params": jax.random.key(0)}, x[:1]))
    v = _perturbed(v, 4)
    want = np.asarray(jax.jit(jmodel.apply)(v, x))

    tbackbone, _ = tbb.create_backbone("resnet18", out_features=dim)
    tmodel = tbb.ImageMILModel(tbackbone, create_model(head, 2, dim, dim, device="cpu"),
                               n_chunks=3)
    tmodel.backbone.load_state_dict(backbone_state_dict_from_jax(
        {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}))
    tmodel.head.load_state_dict(head_state_dict_from_jax(head, v["params"]["head"], dim))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)

    tmodel.train()
    assert not tmodel.backbone.training and tmodel.head.training
    stats = tmodel.backbone.backbone.bn1.running_mean.clone()
    tmodel(torch.from_numpy(x)).sum().backward()
    assert all(p.grad is None for p in tmodel.backbone.parameters())
    assert all(p.grad is not None for p in tmodel.head.parameters() if p.requires_grad)
    assert torch.equal(stats, tmodel.backbone.backbone.bn1.running_mean)
    # the pyramid stream and the other backbones are held in test_torch_backbones.py
    assert tbb.ImageMILModel(tbackbone, tmodel.head, pyramid=True).pyramid
    for name, dim in (("vit", 768), ("dino", 768), ("efficientnet", 512), ("inception", 2048)):
        assert tbb.create_backbone(name)[1] == dim


# ----------------------------------------------------------- extraction

def test_extract_cohort_float32_matches_jax(cohort, resnet_vars, tmp_path):
    """The float32 route (batches of 4, the last ragged; one augmented copy
    a slide): the same files, features within 1e-5 of JAX's, coords equal;
    the port reads JAX's .h5 files as h5py does."""
    import h5py

    jds = JaxJPG(cohort, cohort / "labels.json", "test", 2, tile_size=SIZE)
    jfiles = jfe.extract_cohort(jbb.create_backbone("retccl")[0], resnet_vars, jds,
                                tmp_path / "jax", batch_size=4, n_augment=1, seed=3)
    backbone, _ = tbb.create_backbone("retccl")
    backbone.load_state_dict(backbone_state_dict_from_jax(resnet_vars))
    tds = JPGMILDataset(cohort, cohort / "labels.json", "test", 2, tile_size=SIZE)
    tfiles = tfe.extract_cohort(backbone, tds, tmp_path / "port", batch_size=4, n_augment=1,
                                seed=3, device="cpu")
    assert [p.name for p in tfiles] == [p.name for p in jfiles] == [
        "slide_0.h5", "slide_0_aug0.h5", "slide_1.h5", "slide_1_aug0.h5", "slide_2.h5",
        "slide_2_aug0.h5"]
    for jp, tp in zip(jfiles, tfiles):
        with h5py.File(jp, "r") as f:
            want = {k: f[k][()] for k in f}
        got = h5.read(tp)
        assert sorted(got) == sorted(want) == ["coords", "features"]
        assert got["features"].dtype == np.float32 and got["coords"].dtype == np.int32
        _close(got["features"], want["features"])
        assert got["coords"].tobytes() == want["coords"].tobytes()
        read = h5.read(jp)
        assert all(read[k].tobytes() == want[k].tobytes() for k in want)
    labels = {"test": [[f"{n}.h5", 0] for n in ("slide_0", "slide_1_aug0")]}
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    bags = FeatureBagDataset(tmp_path / "jax", tmp_path / "labels.json", "test", 2)
    assert bags.names == ["slide_0", "slide_1_aug0"]
    feats, coords = bags._load(1)
    with h5py.File(tmp_path / "jax" / "slide_1_aug0.h5", "r") as f:
        assert feats.tobytes() == f["features"][()].tobytes()


@pytest.fixture(scope="module")
def jax_int8(cohort, resnet_vars, tmp_path_factory):
    """JAX's int8 route over the cohort: (its .h5 files, its calibrated q)."""
    captured = {}

    def build(*args, **kw):
        captured["q"] = jax.device_get(_ORIG_JAX_BUILD(*args, **kw))
        return captured["q"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "build_qresnet50", build)
        jds = JaxJPG(cohort, cohort / "labels.json", "test", 2, tile_size=SIZE)
        files = jfe.extract_cohort(jbb.create_backbone("retccl")[0], resnet_vars, jds,
                                   tmp_path_factory.mktemp("jax_int8"), batch_size=4,
                                   quantize="int8")
    return files, captured["q"]


@pytest.mark.parametrize("route", ["int8", "int8_fused"])
def test_extract_cohort_int8_matches_jax_code_for_code(cohort, resnet_vars, jax_int8, tmp_path,
                                                       route, monkeypatch):
    """The int8 routes with JAX's calibrated constants carried across: every
    feature within half of one code's share of JAX's int8 route (a single
    differing code in the last stage fails). The port's own calibration on
    the same tiles lands within a cosine of 0.9999. int8_fused refuses a
    batch its tiles per step do not divide, before calibrating."""
    jfiles, q = jax_int8
    backbone, _ = tbb.create_backbone("retccl")
    backbone.load_state_dict(backbone_state_dict_from_jax(resnet_vars))
    tds = JPGMILDataset(cohort, cohort / "labels.json", "test", 2, tile_size=SIZE)
    own = tfe.extract_cohort(backbone, tds, tmp_path / "own", batch_size=4, quantize=route,
                             device="cpu")
    monkeypatch.setattr(tq, "build_qresnet50", lambda *a, **k: qresnet_from_jax(q))
    tfiles = tfe.extract_cohort(backbone, tds, tmp_path / "port", batch_size=4, quantize=route,
                                device="cpu")
    for jp, tp, op in zip(jfiles, tfiles, own):
        want, got = h5.read(jp), h5.read(tp)
        np.testing.assert_allclose(got["features"], want["features"],
                                   atol=half_code_share(q), rtol=0)
        assert got["coords"].tobytes() == want["coords"].tobytes()
        f = h5.read(op)["features"]
        cos = (f * want["features"]).sum(-1) / (
            np.linalg.norm(f, axis=-1) * np.linalg.norm(want["features"], axis=-1))
        assert cos.min() > 0.9999
    if route == "int8_fused":
        with pytest.raises(ValueError, match="does not divide"):
            tfe.extract_cohort(backbone, tds, tmp_path / "bad", batch_size=3, quantize=route,
                               device="cpu")


_ORIG_JAX_BUILD = jq.build_qresnet50
_ORIG_CREATE_BACKBONE = jbb.create_backbone


def test_cli_extract_features_matches_jax(cohort, resnet_vars, tmp_path, monkeypatch):
    """Both CLIs from one torchvision-named .pth (one slide's tiles resized
    to 224, a batch of 4, --bagstore): the same files, and bag stores with
    the same slides and coords and features within 1e-5. Both decode with
    PIL, as on a machine without libjpeg headers: the native loader resizes
    otherwise, and the JAX package builds its own in place, so a test worker
    that loads it mid-build would take the other route."""
    monkeypatch.setattr(jnt, "available", lambda: False)
    monkeypatch.setattr(tnt, "available", lambda: False)
    ckpt = tmp_path / "retccl.pth"
    torch.save(torchvision_state_dict(resnet_vars), ckpt)
    argv = ["--data_dir", str(cohort), "--label_file", str(cohort / "labels.json"),
            "--backbone", "retccl", "--ckpt", str(ckpt), "--batch_size", "4", "--bagstore",
            "--mode", "cli"]
    monkeypatch.setattr(jbb, "create_backbone", lambda name, **kw: (
        _jitted_init(_ORIG_CREATE_BACKBONE(name, **kw)[0]), _ORIG_CREATE_BACKBONE(name, **kw)[1]))
    jfiles = jcli_extract.main([*argv, "--out_dir", str(tmp_path / "jax")])
    tfiles = tcli_extract.main([*argv, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert [Path(p).name for p in tfiles] == [Path(p).name for p in jfiles]
    jstore, tstore = JaxBagStore(tmp_path / "jax" / "cohort.bags"), BagStore(
        tmp_path / "port" / "cohort.bags")
    assert tstore.n_slides == jstore.n_slides == 1
    _close(tstore.read_bag(0), jstore.read_bag(0))
    assert tstore.read_coords(0).tobytes() == jstore.read_coords(0).tobytes()
    tstore.close()
    jstore.close()


def test_cli_extract_features_summary(cohort, capsys, tmp_path):
    """The summary line is JAX's: slides, files, the width, the out dir."""
    tcli_extract.main(["--data_dir", str(cohort), "--label_file", str(cohort / "labels.json"),
                       "--backbone", "resnet18", "--mode", "train", "--batch_size", "8",
                       "--out_dir", str(tmp_path), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"slides": 3, "files": 3, "dim": 512, "out": str(tmp_path)}
    assert h5.read(tmp_path / "slide_0.h5")["features"].shape == (6, 512)


# ------------------------------------------------------- images training

def _images_config(root: Path, data: dict, weights: Path) -> Path:
    cfg = {
        "General": {"seed": 2021, "precision": 32, "epochs": 1, "grad_acc": 1, "patience": 5,
                    "log_path": str(root / "logs")},
        "Data": {"dataset_name": "custom", "variant": "images", "tile_size": 32, "bag_size": 4,
                 "train_dataloader": {"batch_size": 2}, "test_dataloader": {"batch_size": 1},
                 **data},
        "Model": {"name": "TransMIL", "n_classes": 2, "backbone": "resnet18",
                  "backbone_weights": str(weights), "in_features": 64, "out_features": 64},
        "Optimizer": {"opt": "lookahead_radam", "lr": 1e-3, "weight_decay": 0.01},
        "Loss": {"base_loss": "CrossEntropyLoss"},
    }
    path = root / "DeepGraft" / "TransMIL_images_norm_rest.yaml"
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_train_images_matches_jax(tmp_path, monkeypatch):
    """``cli.train --fast_dev_run`` of an images YAML (TransMIL-64 behind a
    ResNet18 with .pth weights, lookahead_radam with weight decay 0.01):
    both CLIs from the same weights with dropout off; loss and val_loss
    within 1e-4, AUCs within 0.005. JAX's frozen backbone sits in its
    optimizer with zero gradients, so coupled L2 moves its conv kernels (not
    its BatchNorm): the port's move the same way, within 1e-6 (ROADMAP
    C11)."""
    r = np.random.default_rng(9)
    labels = {}
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        labels[split] = []
        for i in range(n):
            name = f"{split}_{i}"
            folder = tmp_path / "data" / "BLOCKS" / name
            folder.mkdir(parents=True)
            for t in range(3 + i % 3 if split == "train" else 4):
                img = (r.integers(0, 200, (32, 32, 3)) + 50 * (i % 2)).astype(np.uint8)
                Image.fromarray(img).save(folder / f"t_({t}-{t}).jpg", quality=95)
            labels[split].append([name, i % 2])
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    jbackbone, _ = jbb.create_backbone("resnet18", out_features=64)
    init = jax.jit(lambda k: jbackbone.init({"params": k}, jnp.zeros((1, 32, 32, 3))))
    bb = _perturbed(jax.device_get(init(jax.random.key(5))), 5)
    raw = {"params": bb["params"]["backbone"], "batch_stats": bb["batch_stats"]["backbone"]}
    torch.save(torchvision_state_dict(raw), tmp_path / "resnet18.pth")
    config = _images_config(tmp_path, {"data_dir": str(tmp_path / "data"),
                                       "label_file": str(tmp_path / "labels.json")},
                            tmp_path / "resnet18.pth")

    trainers, initial = {}, {}

    def jax_build(cfg, log_dir=None):
        t = _ORIG_JAX_TRAIN_BUILD(cfg, log_dir)
        t.cfg.train_deterministic = True
        t.cfg.epoch_figures = False
        t.cfg.export_topk_tiles = False
        _jitted_init(t.model)
        init_params = t.init_params

        def keep_initial(batch):  # key(seed)'s weights, the .pth's frozen ResNet18
            init_params(batch)
            initial.update(jax.device_get(t.params))

        t.init_params = keep_initial
        trainers["jax"] = t
        return t

    monkeypatch.setattr(jcli_train, "build", jax_build)
    jax_summary = jcli_train.main(["--config", str(config), "--log_dir", str(tmp_path / "jax"),
                                   "--fast_dev_run"])
    jt, p0 = trainers["jax"], initial

    def port_build(cfg, log_dir=None, device=None):
        t = _ORIG_PORT_TRAIN_BUILD(cfg, log_dir, device)
        t.cfg.train_deterministic = True
        t.model.head.load_state_dict(head_state_dict_from_jax("TransMIL", p0["head"], 64))
        proj = p0["backbone"]["proj"]
        t.model.backbone.proj.load_state_dict({"weight": torch.tensor(proj["kernel"].T),
                                               "bias": torch.tensor(proj["bias"])})
        trainers["port"] = t
        return t

    monkeypatch.setattr(tcli_train, "build", port_build)
    summary = tcli_train.main(["--config", str(config), "--log_dir", str(tmp_path / "port"),
                               "--fast_dev_run", "--device", "cpu"])

    def rows(log_dir):
        lines = (log_dir / "metrics.jsonl").read_text().splitlines()
        return [r for r in map(json.loads, lines) if "val_loss" in r]

    (jr,), (tr,) = rows(tmp_path / "jax"), rows(tmp_path / "port")
    assert abs(jr["loss"] - tr["loss"]) <= 1e-4 and abs(jr["val_loss"] - tr["val_loss"]) <= 1e-4
    for key in ("train_auc", "val_auc", "val_patient_auc"):
        assert abs(jr[key] - tr[key]) <= 0.005, key
    for key in ("test_auc", "test_patient_auc"):
        assert abs(summary[key] - jax_summary[key]) <= 0.005, key
    assert abs(summary["test_loss"] - jax_summary["test_loss"]) <= 1e-4

    inner = trainers["port"].model.backbone.backbone
    jinner = jax.device_get(jt.params)["backbone"]["backbone"]
    start = raw["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1)
    moved = inner.conv1.weight.detach().numpy()
    assert np.abs(jinner["conv1"]["kernel"].transpose(3, 2, 0, 1) - start).max() > 1e-7
    np.testing.assert_allclose(moved, jinner["conv1"]["kernel"].transpose(3, 2, 0, 1),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(inner.bn1.weight.detach().numpy(), raw["params"]["bn1"]["scale"])
    np.testing.assert_array_equal(inner.bn1.running_mean.numpy(),
                                  raw["batch_stats"]["bn1"]["mean"])


_ORIG_JAX_TRAIN_BUILD = jcli_train.build
_ORIG_PORT_TRAIN_BUILD = tcli_train.build
