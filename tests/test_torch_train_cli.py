"""The port's ``cli.train`` end to end against the JAX package's, on the CPU.

One small YAML (TransMIL at in_features 64 and out_features 64: 8 heads of 8,
32 landmarks; RAdam, grad_acc 2, train batch 2, bags of 32 tiles, 2 epochs)
over a cohort of 8 train, 6 val and 6 test slides written as .npy and .h5
files. Both CLIs train from the same weights with dropout off (torch and
flax dropout masks cannot be shared). Bars: loss and val_loss within 1e-4
epoch for epoch, AUCs within 0.005 (the BASELINE bar). On the JAX run's log
dir, the port's ``--stage test`` reads JAX's msgpack checkpoints, and its
``--resume_training`` continues JAX's state of a run cut after epoch 1; the
port's own fit, stopped by SIGTERM after epoch 1 and resumed, reproduces its
uncut run.
"""

import json
import os
import shutil
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from transmil_deepgraft_tpu.cli import train as jcli
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu_torch.cli import train as tcli
from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

DIM, SEED = 64, 2021
AUC_TOL = 0.005
CONFIG = {
    "General": {"comment": None, "seed": SEED, "fp16": True, "precision": 32, "epochs": 2,
                "grad_acc": 2, "patience": 10, "server": "train", "log_path": "logs/"},
    "Data": {"dataset_name": "custom", "data_shuffle": False, "data_dir": None,
             "label_file": None, "patient_dict": None, "fold": 0, "nfold": 2,
             "cross_val": False, "train_dataloader": {"batch_size": 2, "num_workers": 4},
             "test_dataloader": {"batch_size": 1, "num_workers": 4}, "bag_size": 32,
             "mixup": False, "aug": True, "cache": True},
    "Model": {"name": "TransMIL", "n_classes": 2, "backbone": "features",
              "in_features": DIM, "out_features": DIM},
    "Optimizer": {"opt": "radam", "lr": 1e-3, "opt_eps": None, "opt_betas": None,
                  "momentum": None, "weight_decay": 0.01},
    "Loss": {"base_loss": "CrossEntropyLoss"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_config(root: Path, name: str, **over) -> Path:
    cfg = json.loads(json.dumps(CONFIG))
    for section, values in over.items():
        cfg[section].update(values)
    path = root / "DeepGraft" / name
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cohort, the carried weights, and the JAX runs: two epochs, and one
    epoch (its last.ckpt is the state of a run cut after epoch 1)."""
    import h5py

    root = tmp_path_factory.mktemp("cli")
    r = np.random.default_rng(0)
    data = root / "data" / "FEATURES_RETCCL_2048"
    data.mkdir(parents=True)
    labels, patients = {}, {}
    for split, n in (("train", 8), ("val", 6), ("test", 6), ("test_mixin", 2)):
        labels[split] = []
        for i in range(n):
            name, y = f"{split}_{i}", (i // 2) % 2
            x = (r.standard_normal((int(r.integers(20, 121)), DIM)) + 0.6 * y).astype(np.float32)
            if i % 2:
                with h5py.File(data / f"{name}.h5", "w") as f:
                    f["features"] = x
                labels[split].append([f"FEATURES_RETCCL_2048/{name}.h5", y])
            else:
                np.save(data / f"{name}.npy", x)
                labels[split].append([f"FEATURES_RETCCL_2048/{name}.npy", y])
            patients[name] = f"{split}_p{i // 2}"  # two slides of one label a patient
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps(patients))
    data_over = {"data_dir": str(root / "data"), "label_file": str(root / "labels.json"),
                 "patient_dict": str(root / "patients.json")}
    config = _write_config(root, "TransMIL_feat_norm_rest.yaml", Data=data_over)
    cut = _write_config(root, "TransMIL_cut_norm_rest.yaml", Data=data_over,
                        General={"epochs": 1})

    # the JAX Trainer initializes its weights from key(seed); the port takes them
    params = JaxTransMIL(2, DIM, DIM).init({"params": jax.random.key(SEED)},
                                           jnp.zeros((1, 32, DIM), jnp.float32))["params"]
    weights = state_dict_from_jax(jax.device_get(params), DIM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "build", _jax_build)
        jax_summary = jcli.main(["--config", str(config), "--log_dir", str(root / "jax")])
        jcli.main(["--config", str(cut), "--log_dir", str(root / "jax_cut")])
    return {"root": root, "config": config, "weights": weights, "data": data_over,
            "jax": root / "jax", "jax_cut": root / "jax_cut", "jax_summary": jax_summary}


def _port(run, argv, deterministic=True):
    """The port's CLI on the CPU, its model starting from the carried weights."""
    def build(cfg, log_dir=None, device=None):
        t = _ORIG_PORT_BUILD(cfg, log_dir, device)
        t.cfg.train_deterministic = deterministic
        t.model.load_state_dict(run["weights"])
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "build", build)
        return tcli.main([*argv, "--device", "cpu"])


_ORIG_PORT_BUILD = tcli.build


def _close(jr: dict, tr: dict) -> None:
    assert abs(jr["loss"] - tr["loss"]) <= 1e-4, (jr, tr)
    assert abs(jr["val_loss"] - tr["val_loss"]) <= 1e-4, (jr, tr)
    for key in ("train_auc", "val_auc", "val_patient_auc"):
        assert abs(jr[key] - tr[key]) <= AUC_TOL, (key, jr, tr)


def test_cli_train_matches_jax(run):
    summary = _port(run, ["--config", str(run["config"]), "--log_dir", str(run["root"] / "port")])
    jrows, trows = _rows(run["jax"]), _rows(run["root"] / "port")
    assert len(jrows) == len(trows) == 2
    for jr, tr in zip(jrows, trows):
        assert set(jr) == set(tr)
        _close(jr, tr)
    for key in ("test_auc", "test_patient_auc"):
        assert abs(summary[key] - run["jax_summary"][key]) <= AUC_TOL
    assert abs(summary["test_loss"] - run["jax_summary"]["test_loss"]) <= 1e-4
    port = run["root"] / "port"
    for name in ("TEST_RESULT_PATIENT.csv", "TEST_RESULT_SLIDE.csv", "val_thresholds.csv",
                 "test_metrics.json", "checkpoints/last.ckpt"):
        assert (port / name).exists(), name


def test_stage_test_reads_jax_checkpoints(run):
    """Every msgpack checkpoint of the JAX run loads into the port; last.ckpt
    holds the final weights, whose AUROCs the JAX run's test stage reported."""
    ckpts = sorted(p.name for p in (run["jax"] / "checkpoints").glob("*.ckpt"))
    results = _port(run, ["--stage", "test", "--config", str(run["config"]),
                          "--log_dir", str(run["jax"])])
    assert sorted(results) == ckpts and len(ckpts) >= 2
    last = results["last.ckpt"]
    assert abs(last["auroc"] - run["jax_summary"]["test_auc"]) <= AUC_TOL
    assert abs(last["patient_auroc"] - run["jax_summary"]["test_patient_auc"]) <= AUC_TOL
    assert (run["jax"] / "TEST_LAST_RESULT_SLIDE.csv").exists()


def test_resume_of_a_jax_state_reproduces_the_uncut_run(run, tmp_path):
    """The port resumes JAX's state after epoch 1 (weights, RAdam moments,
    the accumulator, counters) and trains epoch 2 as the uncut JAX run did."""
    shutil.copytree(run["jax_cut"], tmp_path / "cut")
    from transmil_deepgraft_tpu_torch.utils.config import finalize_config, read_yaml

    cfg = finalize_config(read_yaml(run["config"]), config_path=run["config"])
    trainer = tcli.build(cfg, str(tmp_path / "probe"), "cpu")
    assert trainer.load_train_state(tmp_path / "cut" / "checkpoints" / "last.ckpt")
    # 8 train slides, batch 2, grad_acc 2: 2 optimizer steps in epoch 1
    assert (trainer.tx.count, trainer.tx.mini_step) == (2, 0)
    assert trainer._resume_fit_state["epoch"] == 1 and all(m.abs().sum() > 0 for m in trainer.tx.mu)
    summary = _port(run, ["--config", str(run["config"]), "--log_dir", str(tmp_path / "cut"),
                          "--resume_training"])
    rows = _rows(tmp_path / "cut")
    assert [r["step"] for r in rows] == [0, 1]
    _close(_rows(run["jax"])[1], rows[1])
    for key in ("test_auc", "test_patient_auc"):
        assert abs(summary[key] - run["jax_summary"][key]) <= AUC_TOL


def test_preempted_fit_resumes_to_the_uncut_run(run, tmp_path):
    """Dropout on. SIGTERM during epoch 1's validation: the end-of-epoch state
    is saved, no test runs; --resume_training then reproduces the uncut run's
    rows (the dropout stream is seeded per epoch)."""
    argv = ["--config", str(run["config"])]
    _port(run, [*argv, "--log_dir", str(tmp_path / "uncut")], deterministic=False)

    from transmil_deepgraft_tpu_torch.train.trainer import Trainer

    evaluate = Trainer.evaluate

    def evaluate_then_signal(self, mode, *args, **kwargs):
        out = evaluate(self, mode, *args, **kwargs)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "evaluate", evaluate_then_signal)
        out = _port(run, [*argv, "--log_dir", str(tmp_path / "cut")], deterministic=False)
    assert out["event"] == "preempted"
    assert not list((tmp_path / "cut").glob("TEST_RESULT_*.csv"))
    _port(run, [*argv, "--log_dir", str(tmp_path / "cut"), "--resume_training"],
          deterministic=False)
    uncut, resumed = _rows(tmp_path / "uncut"), _rows(tmp_path / "cut")
    assert [r["step"] for r in resumed] == [0, 1]
    for a, b in zip(uncut, resumed):
        for key in ("loss", "val_loss", "train_auc", "val_auc", "lr_scale"):
            assert a[key] == b[key], (key, a, b)


def test_kfold_cli_runs_and_ensembles(run, tmp_path):
    config = _write_config(run["root"], "TransMIL_kfold_norm_rest.yaml", Data={
        **run["data"], "cross_val": True}, General={"epochs": 1})
    out = _port(run, ["--config", str(config), "--log_dir", str(tmp_path),
                      "--profile", str(tmp_path / "trace")])
    assert 0.0 <= out["ensemble_auc"] <= 1.0
    for name in ("kfold/model.0.pt", "kfold/model.1.pt", "kfold/ensemble_metrics.json",
                 "kfold/fold0/test_metrics.json", "kfold/fold1/ENSEMBLE_RESULT_SLIDE.csv",
                 "trace/trace.json", "trace/spans.json"):
        assert (tmp_path / name).exists(), name


def test_fine_tune_stage_continues_from_last_ckpt(run, tmp_path):
    """--stage fine_tune: last.ckpt's weights, then General.ft_epochs epochs
    over train + test_mixin (10 slides: 5 micro-steps of 2 an epoch)."""
    shutil.copytree(run["jax"], tmp_path / "ft")
    config = _write_config(run["root"], "TransMIL_ft_norm_rest.yaml", Data=run["data"],
                           General={"ft_epochs": 1})
    summary = _port(run, ["--stage", "fine_tune", "--config", str(config),
                          "--log_dir", str(tmp_path / "ft")])
    rows = [json.loads(line) for line in (tmp_path / "ft" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows if "val_loss" in r] == [0, 1, 0]  # JAX's 2, then the port's 1
    assert np.isfinite(summary["test_loss"])


@pytest.mark.parametrize("model, match", [("vit", "unknown model 'vit'"),
                                          ("resnet18", "unknown model 'resnet18'"),
                                          ("inception", "unknown model 'inception'")])
def test_cli_refuses_unported_heads(run, tmp_path, model, match):
    """A classic network in Model.name: JAX's KeyError in both CLIs
    (ROADMAP C13; the classic route is Data.variant tiles, in
    test_torch_classic.py)."""
    config = _write_config(tmp_path, "TransMIL_x_norm_rest.yaml", Data=run["data"],
                           Model={"name": model})
    with pytest.raises(KeyError, match=match):
        jcli.main(["--config", str(config), "--log_dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match=f"{match}.*ROADMAP C13"):
        tcli.main(["--config", str(config), "--log_dir", str(tmp_path), "--device", "cpu"])
