"""The rest of the bag-head zoo and the spatial heads through the port's
entry points, on the CPU.

- ``cli.train`` runs the three DeepGraft configs that name these heads
  (DTFDMIL_resnet50_tcmr_viral, CTMIL_feat_norm_rest,
  Resnet50_feat_norm_rest) as written but for their paths and epochs, on
  tiny cohorts (the spatial heads at 16-32 channels and batch 2: their
  configs' 2048- and 768-d volumes at batch 128 and 8 are the card's work);
  JAX's variant rule, the DTFD batch-1 clamp and its two-tier optimizer.
- ``cli.export_model`` writes a bundle of every new bag head from its
  ``.pth``; the bundle, its ``MicroBatcher`` and ``cli.serve``'s
  ``/predict`` give the head's own logits (DTFD's slide prediction), and the
  attention where the head gives it.
- The port loads the DTFD and MDMIL bundles the JAX package exports and
  agrees with them within 1e-3.
- ``cli.infer --model CLAM_MB`` on JPEG tiles (the per-class attention rows
  averaged), and the refusals: CTMIL/``resnet50`` in every serving entry
  point, DTFD in ``cli.infer`` (no per-tile attention).
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
from transmil_deepgraft_tpu.models import create_model as jax_create_model
from transmil_deepgraft_tpu.serving import ServingBundle as JaxBundle
from transmil_deepgraft_tpu.serving import export_serving_bundle as jax_export_serving_bundle
from transmil_deepgraft_tpu_torch.cli import export_model, infer
from transmil_deepgraft_tpu_torch.cli import train as tcli
from transmil_deepgraft_tpu_torch.cli.serve import make_server
from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
from transmil_deepgraft_tpu_torch.models import create_model, head_logits
from transmil_deepgraft_tpu_torch.serving import MicroBatcher, ServingBundle
from transmil_deepgraft_tpu_torch.train.optimizers import TwoTierOptimizer
from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml
from transmil_deepgraft_tpu_torch.utils.torch_weights import load_backbone_variables

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "transmil_deepgraft_tpu" / "configs"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cohort(root: Path, dim: int, counts: dict) -> dict:
    """Per-slide .h5 bags with tile grid coords (inside and past a 50-wide
    window), a label JSON, a patient map; returns the config's Data paths."""
    import h5py

    r = np.random.default_rng(dim)
    data = root / "data" / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels, patients = {}, {}
    for split, n in counts.items():
        labels[split] = []
        for i in range(n):
            name, y, k = f"{split}_{i}", i % 2, int(r.integers(30, 60))
            with h5py.File(data / f"{name}.h5", "w") as f:
                f["features"] = (r.standard_normal((k, dim)) + 0.6 * y).astype(np.float32)
                f["coords"] = np.stack([r.choice(70, k), r.choice(55, k)], -1).astype(np.int32)
            labels[split].append([f"FEATURES_RETCCL_2048/{name}.h5", y])
            patients[name] = f"{split}_p{i}"
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps(patients))
    return {"data_dir": str(root / "data"), "label_file": str(root / "labels.json"),
            "patient_dict": str(root / "patients.json")}


# config: (in_features and train batch for the CPU, None = as written)
TRAIN_CONFIGS = {
    "DeepGraft/DTFDMIL_resnet50_tcmr_viral.yaml": None,
    "DeepGraft/CTMIL_feat_norm_rest.yaml": (32, 2),
    "DeepGraft/Resnet50_feat_norm_rest.yaml": (16, 2),
}


@pytest.mark.parametrize("config", sorted(TRAIN_CONFIGS))
def test_repository_configs_train(config, tmp_path):
    """fast_dev_run of each config: DTFD on 512-d bags cut to 240 tiles (2
    pseudo-bags) at batch 1, on its two tier-wise Adams (100 steps an
    epoch, the milestone at 10,000); CTMIL and resnet50
    on (2, 50, 50, D) volumes of the spatial variant, in float32 under
    ``precision: 16-mixed``, their ``last.ckpt`` keeping the BatchNorm
    running statistics."""
    cfg = yaml.safe_load((CONFIGS / config).read_text())
    cut = TRAIN_CONFIGS[config]
    if cut:
        cfg["Model"]["in_features"], cfg["Data"]["train_dataloader"]["batch_size"] = cut
    batch = cfg["Data"]["train_dataloader"]["batch_size"]
    cfg["Data"].update(_cohort(tmp_path, cfg["Model"]["in_features"],
                               {"train": max(batch, 2), "val": 2, "test": 2}))
    cfg["General"].update({"epochs": 1, "log_path": str(tmp_path / "logs")})
    path = tmp_path / Path(config).parent.name / Path(config).name
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    trainers, shapes, trainer_cfg = [], [], []

    def build(cfg, log_dir=None, device=None):
        trainer_cfg.append(cfg)
        trainers.append(orig_build(cfg, log_dir, device))
        train_step = trainers[-1].train_step
        trainers[-1].train_step = lambda bags, *a: shapes.append(tuple(bags.shape)) or \
            train_step(bags, *a)
        return trainers[-1]

    orig_build = tcli.build
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "build", build)
        summary = tcli.main(["--config", str(path), "--device", "cpu", "--fast_dev_run",
                             "--bag_size", "240", "--log_dir", str(tmp_path / "run")])
    assert np.isfinite(summary["test_loss"])
    trainer = trainers[0]
    model = trainer.model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    name = cfg["Model"]["name"]
    assert type(model).__name__ == {"resnet50": "SpatialResNetMIL"}.get(name, name)
    if name == "DTFDMIL":
        assert isinstance(trainer.tx, TwoTierOptimizer) and trainer.dm.variant == "features"
        assert trainer.tx.tiers[0].schedule(9999) == pytest.approx(1e-4)
        assert trainer.tx.tiers[0].schedule(10000) == pytest.approx(2e-5)
        assert shapes == [(1, 240, 512)]
    else:
        assert trainer.dm.variant == "spatial"
        assert shapes == [(batch, 50, 50, cfg["Model"]["in_features"])]
        assert any(int(b) > 0 for n, b in model.named_buffers() if "num_batches" in n)
        # last.ckpt keeps the running statistics the train step moved
        resumed = orig_build(trainer_cfg[0], str(tmp_path / "resumed"), "cpu")
        assert resumed.load_train_state(tmp_path / "run" / "checkpoints" / "last.ckpt")
        for (key, got), (_, want) in zip(resumed.model.named_buffers(), model.named_buffers()):
            assert torch.equal(got, want), key


def test_dtfd_batch_is_clamped_with_a_notice(tmp_path, capsys):
    cfg = yaml.safe_load((CONFIGS / "DeepGraft/DTFDMIL_resnet50_tcmr_viral.yaml").read_text())
    cfg["Data"]["train_dataloader"]["batch_size"] = 4
    cfg["Data"].update(_cohort(tmp_path, 512, {"train": 4, "val": 2, "test": 2}))
    path = tmp_path / "DeepGraft" / "DTFDMIL_x_tcmr_viral.yaml"
    path.parent.mkdir()
    path.write_text(yaml.safe_dump(cfg))
    trainer = tcli.build(finalize_config(read_yaml(path), config_path=path), str(tmp_path),
                         "cpu")
    assert trainer.dm.batch_size == 1
    assert "DTFD requires batch_size=1 (configured 4); clamping" in capsys.readouterr().out
    # JAX's steps_per_epoch: 100 // the configured batch, whatever the cohort (ROADMAP C10)
    assert trainer.tx.tiers[0].schedule(25 * 100 - 1) == pytest.approx(1e-4)
    assert trainer.tx.tiers[0].schedule(25 * 100) == pytest.approx(2e-5)


# ---------------------------------------------------------------- bundles

def _http(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/predict", body=body, headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    out = json.loads(r.read())
    conn.close()
    return r.status, out


@pytest.mark.parametrize("name, in_f, knobs", [
    ("CLAM_SB", 64, {}), ("CLAM_MB", 64, {"instance_classifiers": True}), ("DTFD", 64, {}),
    ("MDMIL", 48, {}), ("DSMIL", 32, {}),
])
def test_export_model_bundles_serve_every_bag_head(name, in_f, knobs, tmp_path):
    """cli.export_model from the head's .pth -> ServingBundle, MicroBatcher
    and cli.serve's /predict, against the head's logits on the
    bucket-padded bag (DTFD: its pseudo-bags over the padded 256 rows)."""
    torch.manual_seed(3)
    out_f = 64 if name == "MDMIL" else 512
    head = create_model(name, 3, in_f, out_f, device="cpu", **knobs).eval()
    torch.save(head.state_dict(), tmp_path / "head.pth")
    export_model.main(["--model", name, "--ckpt", str(tmp_path / "head.pth"), "--out",
                       str(tmp_path / "b.tdx"), "--in_features", str(in_f), "--n_classes", "3",
                       "--buckets", "64,256"])
    bundle = ServingBundle.load(tmp_path / "b.tdx", device="cpu")
    assert bundle.meta["attention"] == (name != "DTFD")
    rng = np.random.default_rng(4)
    n = 200 if name == "DTFD" else 40
    bag = rng.standard_normal((n, in_f)).astype(np.float32)
    x = torch.zeros(1, 256 if name == "DTFD" else 64, in_f)
    x[0, :n] = torch.from_numpy(bag)
    with torch.no_grad():
        want = head_logits(head, x).numpy()
    np.testing.assert_allclose(bundle.predict_logits(bag), want, atol=1e-5, rtol=0)
    batcher = MicroBatcher(bundle)
    srv = make_server(bundle, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        np.testing.assert_allclose(batcher.predict_logits(bag), want, atol=1e-5, rtol=0)
        status, out = _http(srv.server_address[1], json.dumps({"features": bag.tolist()}))
        assert status == 200, out
        np.testing.assert_allclose(out["logits"], want, atol=1e-5, rtol=0)
    finally:
        batcher.close()
        srv.shutdown()
        srv.server_close()
    if bundle.meta["attention"]:
        logits, scores = bundle.predict_logits_with_attention(bag)
        np.testing.assert_allclose(logits, want, atol=1e-5, rtol=0)
        assert scores.shape == (1, n) and np.isfinite(scores).all()
    else:
        with pytest.raises(ValueError, match="without attention"):
            bundle.predict_logits_with_attention(bag)


@pytest.mark.parametrize("name", ["DTFD", "MDMIL"])
def test_port_loads_jax_bundles(name, tmp_path):
    """The bundle JAX exports (its eval forward takes DTFD's slide logits and
    MDMIL's first output), served by the port within 1e-3 of JAX's."""
    in_f, out_f, n = 32, 64, 150
    model = jax_create_model(name, 2, in_f, out_f)
    variables = jax.device_get(jax.jit(model.init)(jax.random.key(1),
                                                   jnp.zeros((1, 256, in_f))))
    path = tmp_path / "b.tdx"
    jax_export_serving_bundle(model, variables, path, model_name=name, in_features=in_f,
                              buckets=(256,), platforms=("cpu",), symbolic=False,
                              attention=name == "MDMIL")
    got = ServingBundle.load(path, device="cpu")
    bag = np.random.default_rng(2).standard_normal((n, in_f)).astype(np.float32)
    want = JaxBundle.load(path)
    np.testing.assert_allclose(got.predict_logits(bag), want.predict_logits(bag), atol=1e-3,
                               rtol=0)
    if name == "MDMIL":
        g_logits, g_scores = got.predict_logits_with_attention(bag)
        w_logits, w_scores = want.predict_logits_with_attention(bag)
        np.testing.assert_allclose(g_logits, w_logits, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g_scores, w_scores, atol=1e-3, rtol=0)


def test_infer_clam_mb_and_the_refusals(tmp_path):
    """cli.infer --model CLAM_MB on 2 slides x 5 JPEG tiles gives the
    pipeline's probabilities and its per-tile scores, the mean of the
    per-class attention rows; cli.infer refuses the heads without per-tile
    attention (DTFD, the spatial ResNet), and a spatial head's bundle needs
    its BatchNorm statistics (the spatial heads serve, as JAX's bundles do:
    tests/test_torch_spatial_serving.py)."""
    torch.save(torchvision_state_dict(perturbed_resnet_variables(5)), tmp_path / "bb.pth")
    torch.manual_seed(5)
    head = create_model("CLAM_MB", 3, 2048, device="cpu").eval()
    torch.save(head.state_dict(), tmp_path / "head.pth")
    rng = np.random.default_rng(6)
    for slide in ("slideA", "slideB"):
        d = tmp_path / "tiles" / slide
        d.mkdir(parents=True)
        for t in range(5):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                d / f"tile_({t}-{t * t}).jpg", quality=90)
    args = ["--tiles_root", str(tmp_path / "tiles"), "--backbone_ckpt", str(tmp_path / "bb.pth"),
            "--head_ckpt", str(tmp_path / "head.pth"), "--quantize", "bf16", "--chunk", "4",
            "--tile_size", "64", "--out_dir", str(tmp_path / "out"), "--device", "cpu"]
    got = infer.main(args + ["--model", "CLAM_MB"])
    pipeline = SlideInferencePipeline(load_backbone_variables(tmp_path / "bb.pth"), head,
                                      chunk=4, device="cpu")
    for slide, result in zip(("slideA", "slideB"), got):
        paths = sorted((tmp_path / "tiles" / slide).glob("*.jpg"))
        probs, scores = pipeline.predict_slide_paths_with_attention(paths, tile_size=64)
        np.testing.assert_allclose(result["probs"], probs, atol=1e-5, rtol=0)
        feats = pipeline.embed_device(np.stack([np.asarray(Image.open(p)) for p in paths]))
        with torch.no_grad():
            _, attn = head(feats[None], return_attn=True)  # (3, 5) per-class rows
        np.testing.assert_allclose(scores, attn.mean(0).numpy(), atol=1e-5, rtol=0)

    for name in ("DTFD", "resnet50"):
        with pytest.raises(SystemExit, match="no per-tile attention"):
            infer.main(args + ["--model", name])
    for name in ("CTMIL", "resnet50"):
        with pytest.raises(ValueError, match="BatchNorm statistics"):
            ServingBundle({"model_name": name, "in_features": 2048, "coord_aware": False},
                          {"fc": {"kernel": np.zeros((512, 2), np.float32)}}, device="cpu")
