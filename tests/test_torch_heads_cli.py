"""The ported heads through the port's entry points, on the CPU.

- ``cli.train`` of AttMIL and of RoFormerMIL (with the bags' tile coordinates
  from .h5 files, and its knobs from ``cfg.Model``) against the JAX package's
  ``cli.train`` on one tiny cohort, from the same weights with dropout off:
  loss and val_loss within 1e-4 epoch for epoch, AUCs within 0.005.
- ``cli.train`` runs the repository's configs of each ported head with only
  the paths and epochs changed (``--fast_dev_run``, bags cut to 8 tiles by
  ``--bag_size``), and the heads train in float32 under ``precision: 16``.
- The port loads the AttMIL and RoFormerMIL bundles the JAX package exports
  and agrees with them (logits and attention) within 1e-3, coords included.
- ``cli.export_model`` writes a bundle of every ported head from a ``.pth``;
  the bundle, its ``MicroBatcher`` and ``cli.serve``'s ``/predict`` (with
  coords for RoFormerMIL) give the head's own logits.
- ``cli.infer --model RoFormerMIL`` gives the tiles their file-name coords.
"""

import http.client
import json
import threading
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
from transmil_deepgraft_tpu.cli import train as jcli
from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu.serving import ServingBundle as JaxBundle
from transmil_deepgraft_tpu.serving import export_serving_bundle as jax_export_serving_bundle
from transmil_deepgraft_tpu_torch.cli import export_model, infer
from transmil_deepgraft_tpu_torch.cli import train as tcli
from transmil_deepgraft_tpu_torch.cli.serve import make_server
from transmil_deepgraft_tpu_torch.data.coords import normalize_pad_coords
from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.serving import MicroBatcher, ServingBundle
from transmil_deepgraft_tpu_torch.utils.jax_params import head_state_dict_from_jax
from transmil_deepgraft_tpu_torch.utils.torch_weights import load_backbone_variables

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "transmil_deepgraft_tpu" / "configs"
DIM, SEED, AUC_TOL, TOL = 64, 2021, 0.005, 1e-3
ROFORMER = {"depth": 2, "heads": 2, "dim_head": 16, "mlp_dim": 32}
# the RoFormerMIL knobs its weights show (the others are the defaults)
ROFORMER_SHOWN = {"depth": 2, "mlp_dim": 32}
CONFIG = {
    "General": {"seed": SEED, "precision": 32, "epochs": 2, "grad_acc": 2, "patience": 10,
                "server": "train", "log_path": "logs/"},
    "Data": {"dataset_name": "custom", "data_dir": None, "label_file": None,
             "patient_dict": None, "fold": 0, "nfold": 2, "cross_val": False,
             "train_dataloader": {"batch_size": 2}, "test_dataloader": {"batch_size": 1},
             "bag_size": 32, "mixup": False},
    "Model": {"name": None, "n_classes": 2, "backbone": "features", "in_features": DIM,
              "out_features": 32},
    "Optimizer": {"opt": "radam", "lr": 1e-3, "opt_eps": None, "opt_betas": None,
                  "momentum": None, "weight_decay": 0.01},
    "Loss": {"base_loss": "CrossEntropyLoss"},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cohort(root: Path, dim: int, counts: dict, tiles=(20, 60), coords: bool = False) -> dict:
    """Per-slide bags (.h5 with coords, else .npy), a label JSON and a
    patient map of two slides a patient; returns the config's Data paths."""
    import h5py

    r = np.random.default_rng(dim)
    data = root / "data" / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels, patients = {}, {}
    for split, n in counts.items():
        labels[split] = []
        for i in range(n):
            name, y = f"{split}_{i}", (i // 2) % 2
            k = int(r.integers(*tiles))
            x = (r.standard_normal((k, dim)) + 0.6 * y).astype(np.float32)
            if coords:
                with h5py.File(data / f"{name}.h5", "w") as f:
                    f["features"] = x
                    f["coords"] = r.integers(100, 160, (k, 2)).astype(np.int32)
                labels[split].append([f"FEATURES_RETCCL_2048/{name}.h5", y])
            else:
                np.save(data / f"{name}.npy", x)
                labels[split].append([f"FEATURES_RETCCL_2048/{name}.npy", y])
            patients[name] = f"{split}_p{i // 2}"
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps(patients))
    return {"data_dir": str(root / "data"), "label_file": str(root / "labels.json"),
            "patient_dict": str(root / "patients.json")}


def _write(path: Path, cfg: dict) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def _rows(log_dir) -> list[dict]:
    lines = (Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if "val_loss" in r]


def _jax_build(cfg, log_dir=None):
    t = _ORIG_JAX_BUILD(cfg, log_dir)
    t.cfg.train_deterministic = True
    t.cfg.epoch_figures = False
    t.cfg.export_topk_tiles = False
    return t


_ORIG_JAX_BUILD = jcli.build
_ORIG_PORT_BUILD = tcli.build


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One cohort (RoFormerMIL's with coords), the weights JAX initializes
    from key(seed), and JAX's 2-epoch runs of AttMIL and RoFormerMIL."""
    out = {}
    for name, knobs in (("AttMIL", {}), ("RoFormerMIL", ROFORMER)):
        root = tmp_path_factory.mktemp(name)
        data = _cohort(root, DIM, {"train": 8, "val": 6, "test": 6},
                       coords=name == "RoFormerMIL")
        cfg = json.loads(json.dumps(CONFIG))
        cfg["Data"].update(data)
        cfg["Model"].update({"name": name, **knobs})
        config = _write(root / "DeepGraft" / f"{name}_feat_norm_rest.yaml", cfg)
        params = jax.jit(jax_create_model(name, 2, DIM, 32, **knobs).init)(
            {"params": jax.random.key(SEED)}, jnp.zeros((1, 32, DIM), jnp.float32))["params"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcli, "build", _jax_build)
            summary = jcli.main(["--config", str(config), "--log_dir", str(root / "jax")])
        out[name] = {"root": root, "config": config, "summary": summary,
                     "weights": head_state_dict_from_jax(name, jax.device_get(params), DIM)}
    return out


@pytest.mark.parametrize("name", ["AttMIL", "RoFormerMIL"])
def test_cli_train_matches_jax(runs, name):
    run = runs[name]
    trainers = []

    def build(cfg, log_dir=None, device=None):
        t = _ORIG_PORT_BUILD(cfg, log_dir, device)
        t.cfg.train_deterministic = True
        t.model.load_state_dict(run["weights"])
        trainers.append(t)
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "build", build)
        summary = tcli.main(["--config", str(run["config"]), "--log_dir",
                             str(run["root"] / "port"), "--device", "cpu"])
    assert trainers[0].coord_aware == (name == "RoFormerMIL")
    if name == "RoFormerMIL":  # the knobs of cfg.Model reach the head
        assert trainers[0].model.depth == ROFORMER["depth"]
    jrows, trows = _rows(run["root"] / "jax"), _rows(run["root"] / "port")
    assert len(jrows) == len(trows) == 2
    for jr, tr in zip(jrows, trows):
        assert abs(jr["loss"] - tr["loss"]) <= 1e-4, (jr, tr)
        assert abs(jr["val_loss"] - tr["val_loss"]) <= 1e-4, (jr, tr)
        for key in ("train_auc", "val_auc", "val_patient_auc"):
            assert abs(jr[key] - tr[key]) <= AUC_TOL, (key, jr, tr)
    assert abs(summary["test_loss"] - run["summary"]["test_loss"]) <= 1e-4
    for key in ("test_auc", "test_patient_auc"):
        assert abs(summary[key] - run["summary"][key]) <= AUC_TOL


@pytest.mark.parametrize("name", ["AttMIL", "RoFormerMIL"])
def test_port_resumes_jax_checkpoints(runs, name, tmp_path):
    """JAX's last.ckpt of the head's run: its weights give the JAX run's
    test loss in the port, and its optax state (4 optimizer steps of
    lookahead-free RAdam, grad_acc 2) carries over in the head's leaf order."""
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml

    run = runs[name]
    cfg = finalize_config(read_yaml(run["config"]), config_path=run["config"])
    trainer = tcli.build(cfg, str(tmp_path), "cpu")
    assert trainer.load_train_state(run["root"] / "jax" / "checkpoints" / "last.ckpt")
    assert trainer.tx.count == 4 and trainer._resume_fit_state["epoch"] == 2
    assert abs(trainer.evaluate("test")["loss"] - run["summary"]["test_loss"]) <= 1e-4


@pytest.mark.parametrize("config", [
    "DeepGraft/AttMIL_feat_norm_rest.yaml", "DeepGraft/TransformerMIL_feat_norm_rest.yaml",
    "DeepGraft/TransformerMIL_retccl_norm_rest.yaml", "DeepGraft/Chowder_resnet50_bin_1.yaml",
    "synthetic_roformer_norm_rest.yaml", "DeepGraft/AttTrans_resnet50_norm_rest.yaml",
])
def test_repository_configs_train(config, tmp_path):
    """Each ported head's config as written but for its paths and epochs, on
    a cohort of its in_features; fast_dev_run, train bags cut to 8 tiles
    (an eval bag is a 10% draw of its tiles, and Chowder takes 5 of them)."""
    cfg = yaml.safe_load((CONFIGS / config).read_text())
    if cfg["Data"].get("synthetic"):
        cfg["Data"]["synthetic"].update({"n_train": 4, "n_val": 2, "n_test": 2})
    else:
        batch = cfg["Data"]["train_dataloader"]["batch_size"]
        cfg["Data"].update(_cohort(tmp_path, cfg["Model"]["in_features"],
                                   {"train": batch, "val": 2, "test": 2}, tiles=(50, 61)))
    cfg["General"].update({"epochs": 1, "log_path": str(tmp_path / "logs")})
    path = _write(tmp_path / Path(config).parent.name / Path(config).name, cfg)
    trainers = []

    def build(cfg, log_dir=None, device=None):
        trainers.append(_ORIG_PORT_BUILD(cfg, log_dir, device))
        return trainers[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "build", build)
        summary = tcli.main(["--config", str(path), "--device", "cpu", "--fast_dev_run",
                             "--bag_size", "8", "--log_dir", str(tmp_path / "run")])
    assert np.isfinite(summary["test_loss"])
    model = trainers[0].model
    assert type(model).__name__ == {"AttTrans": "MonaiMIL"}.get(cfg["Model"]["name"],
                                                                  cfg["Model"]["name"])
    assert all(p.dtype == torch.float32 for p in model.parameters())  # precision 16 too


# ---------------------------------------------------------------- bundles

@pytest.mark.parametrize("name, knobs", [("AttMIL", {}), ("RoFormerMIL", {}),
                                         ("RoFormerMIL", {**ROFORMER, "num_landmarks": 8})])
def test_port_loads_jax_bundles(name, knobs, tmp_path):
    """The bundle the JAX package exports, served by the port: logits and
    attention scores within 1e-3 of the JAX bundle's, coords and the
    coord-less fallback alike. JAX's meta holds no knobs: ``load`` reads the
    widths and depths from the weights and takes the defaults for the rest;
    a RoFormerMIL of other heads and landmarks (which the weights do not
    show) gets them from ``knobs`` in the meta."""
    model = jax_create_model(name, 3, DIM, 32, **knobs)
    variables = jax.device_get(jax.jit(model.init)(jax.random.key(1), jnp.zeros((1, 64, DIM))))
    path = tmp_path / "b.tdx"
    jax_export_serving_bundle(model, variables, path, model_name=name, in_features=DIM,
                              buckets=(64,), platforms=("cpu",), symbolic=False)
    want = JaxBundle.load(path)
    if knobs:
        import zipfile

        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
        meta.update(n_classes=3, knobs={k: knobs[k] for k in ("heads", "num_landmarks")
                                        if k in knobs})
        got = ServingBundle(meta, variables["params"], device="cpu")
    else:
        got = ServingBundle.load(path, device="cpu")
    assert got.coord_aware == (name == "RoFormerMIL")
    rng = np.random.default_rng(2)
    bag = rng.standard_normal((50, DIM)).astype(np.float32)
    coords = rng.integers(500, 600, (50, 2)).astype(np.float32)
    for c in ((coords, None) if got.coord_aware else (None,)):
        np.testing.assert_allclose(got.predict_logits(bag, c), want.predict_logits(bag, c),
                                   atol=TOL, rtol=0)
        g_logits, g_scores = got.predict_logits_with_attention(bag, c)
        w_logits, w_scores = want.predict_logits_with_attention(bag, c)
        np.testing.assert_allclose(g_logits, w_logits, atol=TOL, rtol=0)
        np.testing.assert_allclose(g_scores, w_scores, atol=TOL, rtol=0)
    if not got.coord_aware:
        with pytest.raises(ValueError, match="not coord-aware"):
            got.predict_logits(bag, coords)


def _http(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/predict", body=body, headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    out = json.loads(r.read())
    conn.close()
    return r.status, out


@pytest.mark.parametrize("name, in_f, knobs", [
    ("TransformerMIL", 768, {}), ("AttMIL", 2048, {}), ("Chowder", 512, {}),
    ("AttTrans", 64, {"trans_blocks": 1}), ("RoFormerMIL", 96, ROFORMER_SHOWN),
])
def test_export_model_bundles_serve_every_head(name, in_f, knobs, tmp_path):
    """cli.export_model from the head's .pth (the reference's names; the
    knobs are those its weights show) -> ServingBundle, MicroBatcher and
    cli.serve's /predict, against the head itself on the bucket-padded bag
    (and its normalized, padded coords)."""
    torch.manual_seed(3)
    head = create_model(name, 2, in_f, device="cpu", **knobs).eval()
    torch.save(head.state_dict(), tmp_path / "head.pth")
    export_model.main(["--model", name, "--ckpt", str(tmp_path / "head.pth"), "--out",
                       str(tmp_path / "b.tdx"), "--in_features", str(in_f), "--buckets",
                       "32,64"])
    bundle = ServingBundle.load(tmp_path / "b.tdx", device="cpu")
    assert bundle.meta["model_name"] == name and bundle.coord_aware == (name == "RoFormerMIL")
    rng = np.random.default_rng(4)
    bag = rng.standard_normal((40, in_f)).astype(np.float32)
    coords = rng.integers(10, 50, (40, 2)).astype(np.float32) if bundle.coord_aware else None
    x = torch.zeros(1, 64, in_f)
    x[0, :40] = torch.from_numpy(bag)
    with torch.no_grad():
        want = (head(x, torch.from_numpy(normalize_pad_coords(coords, 64)[None]))
                if bundle.coord_aware else head(x)).numpy()
    np.testing.assert_allclose(bundle.predict_logits(bag, coords), want, atol=1e-5, rtol=0)
    batcher = MicroBatcher(bundle)
    srv = make_server(bundle, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        np.testing.assert_allclose(batcher.predict_logits(bag, coords), want, atol=1e-5, rtol=0)
        doc = {"features": bag.tolist()}
        if coords is not None:
            doc["coords"] = coords.tolist()
        status, out = _http(srv.server_address[1], json.dumps(doc))
        assert status == 200, out
        np.testing.assert_allclose(out["logits"], want, atol=1e-5, rtol=0)
    finally:
        batcher.close()
        srv.shutdown()
        srv.server_close()
    if bundle.meta["attention"]:
        _, scores = bundle.predict_logits_with_attention(bag, coords)
        assert scores.shape == (1, 40) and np.isfinite(scores).all()


def test_infer_gives_roformer_the_file_name_coords(tmp_path):
    """cli.infer --model RoFormerMIL on 2 slides x 5 JPEG tiles named
    tile_(x-y).jpg: the probabilities of the pipeline given those coords,
    which differ from the square-grid fallback's."""
    torch.save(torchvision_state_dict(perturbed_resnet_variables(5)), tmp_path / "bb.pth")
    torch.manual_seed(5)
    head = create_model("RoFormerMIL", 2, 2048, 32, device="cpu", **ROFORMER_SHOWN)
    torch.save(head.state_dict(), tmp_path / "head.pth")
    rng = np.random.default_rng(6)
    for s, slide in enumerate(("slideA", "slideB")):
        d = tmp_path / "tiles" / slide
        d.mkdir(parents=True)
        for t in range(5):
            arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"tile_({7 * t + s}-{3 + t * t}).jpg", quality=90)
    got = infer.main(["--tiles_root", str(tmp_path / "tiles"), "--backbone_ckpt",
                      str(tmp_path / "bb.pth"), "--head_ckpt", str(tmp_path / "head.pth"),
                      "--model", "RoFormerMIL", "--quantize", "bf16", "--chunk", "4",
                      "--tile_size", "64", "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    pipeline = SlideInferencePipeline(load_backbone_variables(tmp_path / "bb.pth"), head,
                                      chunk=4, device="cpu")
    assert pipeline.coord_aware
    for slide, result in zip(("slideA", "slideB"), got):
        paths = sorted((tmp_path / "tiles" / slide).glob("*.jpg"))
        coords = np.asarray([[float(v) for v in p.stem[6:-1].split("-")] for p in paths])
        want = pipeline.predict_slide_paths(paths, coords, tile_size=64)
        np.testing.assert_allclose(result["probs"], want, atol=1e-5, rtol=0)
        grid = pipeline.predict_slide_paths(paths, tile_size=64)
        assert np.abs(grid - want).max() > 1e-6
