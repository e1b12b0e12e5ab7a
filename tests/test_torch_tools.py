"""The port's analysis tools against the JAX package's, on the CPU.

- ``EnergyTracker``: kWh = seconds x watts x chips / 3.6e6 and kgCO2, equal
  to JAX's report on the same seconds; ``regional_impact`` rows and the
  files of ``write_regional_impact`` equal to JAX's; without a card and
  without ``chip_watts`` the tracker refuses (no TPU default is carried
  over);
- ``benchmark_models`` (inference and train) runs, its CSV columns and row
  keys equal to JAX's; ``cli.sustainability --regions``;
- ``bootstrap_auroc`` / ``bootstrap_auroc_per_class``: equal to JAX's on the
  same seed;
- ``scan_log_tree`` and ``export_combined`` over one log tree written by the
  JAX Trainer's ``_save_results``: the same runs and the same combined CSV
  (bytes), the same bootstrap JSON and figure files; ``cli.export_metrics``
  of both packages writes the same CSV;
- each ``cli._entry`` shim runs its port CLI's ``main`` and returns 0;
  ``StepTimer.summary`` has JAX's keys; ``trace`` writes a Chrome trace.
"""

import csv
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.cli import export_metrics as jcli_export
from transmil_deepgraft_tpu.train.aggregation import aggregate_patients
from transmil_deepgraft_tpu.train.trainer import Trainer as JTrainer
from transmil_deepgraft_tpu.utils import export_metrics as jexport
from transmil_deepgraft_tpu.utils import profiling as jprof
from transmil_deepgraft_tpu.utils import sustainability as jsus
from transmil_deepgraft_tpu_torch.cli import _entry
from transmil_deepgraft_tpu_torch.cli import export_metrics as tcli_export
from transmil_deepgraft_tpu_torch.cli import sustainability as tcli_sus
from transmil_deepgraft_tpu_torch.utils import export_metrics as texport
from transmil_deepgraft_tpu_torch.utils import profiling as tprof
from transmil_deepgraft_tpu_torch.utils import sustainability as tsus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers on the
    machine's cores, and the port's plain paths are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def test_energy_tracker_is_jax_formula():
    for watts, chips in ((700.0, 1), (350.0, 4)):
        mine = tsus.EnergyTracker(chip_watts=watts, n_chips=chips)
        theirs = jsus.EnergyTracker(chip_watts=watts, n_chips=chips)
        with mine, theirs:
            time.sleep(0.01)
        mine.step(3)
        theirs.step(3)
        mine._elapsed = theirs._elapsed = 12.5  # the same seconds on both
        assert mine.report().as_dict() == theirs.report().as_dict()
        assert mine.report().kwh == 12.5 * watts * chips / 3.6e6


def test_tracker_takes_watts_from_the_card_or_the_caller(monkeypatch):
    assert not hasattr(tsus, "DEFAULT_CHIP_WATTS")  # a TPU guess, not carried over
    monkeypatch.setattr(tsus.torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="chip_watts"):
        tsus.EnergyTracker()
    with pytest.raises(ValueError, match="chip_watts"):
        tsus.benchmark_models("unused", model_names=("AttMIL",), device="cpu")
    assert tsus.EnergyTracker(chip_watts=123.0).chip_watts == 123.0


def test_card_watts_asks_a_stalled_query_again_and_reads_once(monkeypatch):
    calls = []

    def run(cmd, timeout, **kw):
        calls.append(cmd)
        if len(calls) < tsus.SMI_ATTEMPTS:
            raise tsus.subprocess.TimeoutExpired(cmd, timeout)
        return types.SimpleNamespace(stdout="650.00\n")

    monkeypatch.setattr(tsus.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsus.subprocess, "run", run)
    monkeypatch.setattr(tsus, "_card_watts_cache", {})
    assert tsus.card_watts("cuda:3") == 650.0
    assert tsus.card_watts("cuda:3") == 650.0  # from the first read
    assert len(calls) == tsus.SMI_ATTEMPTS and all("--id=3" in c for c in calls)

    def stalled(cmd, timeout, **kw):
        calls.append(cmd)
        raise tsus.subprocess.TimeoutExpired(cmd, timeout)

    calls.clear()
    monkeypatch.setattr(tsus.subprocess, "run", stalled)
    with pytest.raises(ValueError, match="chip_watts"):
        tsus.card_watts("cuda:1")
    assert len(calls) == tsus.SMI_ATTEMPTS
    assert 1 not in tsus._card_watts_cache


def test_regional_impact_rows_and_files_equal_jax(tmp_path):
    assert tsus.REGION_GCO2_PER_KWH == jsus.REGION_GCO2_PER_KWH
    for kwh, regions in ((12.5, None), (2.0, {"A": 100.0, "B": 50.0})):
        assert tsus.regional_impact(kwh, regions) == jsus.regional_impact(kwh, regions)
    for mod, name in ((tsus, "port"), (jsus, "jax")):
        mod.write_regional_impact(3.25, tmp_path / name / "regional.csv")
    for suffix in (".csv", ".json"):
        assert ((tmp_path / "port" / "regional").with_suffix(suffix).read_bytes()
                == (tmp_path / "jax" / "regional").with_suffix(suffix).read_bytes())
    with pytest.raises(ValueError):
        tsus.regional_impact(1.0, {})


@pytest.mark.parametrize("mode", ["inference", "train"])
def test_benchmark_models_csv_is_jax_layout(tmp_path, mode):
    kw = dict(bag_sizes=(24,), in_features=16, reps=2, mode=mode)
    want = jsus.benchmark_models(tmp_path / "jax", model_names=("AttMIL",), chip_watts=200.0,
                                 **kw)
    got = tsus.benchmark_models(tmp_path / "port",
                                model_names=("TransMIL", "AttMIL", "TransformerMIL", "CLAM_SB"),
                                chip_watts=200.0, device="cpu", **kw)
    assert got.name == want.name == f"sustainability_{mode}.csv"
    with open(want) as f:
        jrows = list(csv.DictReader(f))
    with open(got) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == list(jrows[0])
    assert [r["model"] for r in rows] == ["TransMIL", "AttMIL", "TransformerMIL", "CLAM_SB"]
    for r in rows:
        assert r["mode"] == mode and r["reps"] == "2" and float(r["seconds"]) > 0
        # the CSV's seconds are rounded to 4 decimals, its kWh are not
        assert abs(float(r["kwh"]) - float(r["seconds"]) * 200.0 / 3.6e6) <= 5e-5 * 200.0 / 3.6e6
    jjson = json.loads((tmp_path / "jax" / f"sustainability_{mode}.json").read_text())
    assert [list(r) for r in json.loads(got.with_suffix(".json").read_text())][0] == list(jjson[0])


def test_sustainability_cli_with_regions(tmp_path, capsys):
    out = tcli_sus.main(["--models", "AttMIL", "--bag_sizes", "16", "--in_features", "8",
                         "--reps", "2", "--chip_watts", "400", "--regions", "--device", "cpu",
                         "--out_dir", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["csv"] == out and Path(printed["regional_csv"]).exists()
    assert (tmp_path / "regional_impact_inference.png").exists()


def _probs(seed: int, n: int, n_classes: int):
    r = np.random.default_rng(seed)
    targets = r.integers(0, n_classes, n)
    logits = r.standard_normal((n, n_classes)) + 1.5 * np.eye(n_classes)[targets]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return probs, targets


@pytest.mark.parametrize("n_classes", [2, 3])
def test_bootstrap_auroc_equals_jax(n_classes):
    probs, targets = _probs(n_classes, 30, n_classes)
    kw = dict(n_boot=200, seed=7)
    assert (texport.bootstrap_auroc(probs, targets, n_classes, **kw)
            == jexport.bootstrap_auroc(probs, targets, n_classes, **kw))
    assert (texport.bootstrap_auroc_per_class(probs, targets, n_classes, **kw)
            == jexport.bootstrap_auroc_per_class(probs, targets, n_classes, **kw))


@pytest.fixture(scope="module")
def log_tree(tmp_path_factory):
    """{root}/{project}/{model}/{task}/_{backbone}_{loss}[/fold{k}] run dirs,
    each with the JAX Trainer's TEST_RESULT_PATIENT.csv; one run without."""
    root = tmp_path_factory.mktemp("logs")
    runs = [("DeepGraft", "TransMIL", "norm_rest", "_features_CE", None),
            ("DeepGraft", "AttMIL", "norm_rest", "_features_CE", None),
            ("DeepGraft", "TransMIL", "norm_rest", "_retccl_CE", "fold0"),
            ("Other", "TransMIL", "tcmr", "_features_CE", None)]
    for i, (*parts, fold) in enumerate(runs):
        d = root.joinpath(*parts, *([fold] if fold else []))
        d.mkdir(parents=True)
        probs, targets = _probs(10 + i, 24, 2)
        names = [f"s{j}" for j in range(24)]
        agg = aggregate_patients(probs, targets, names, [f"p{j // 2}" for j in range(24)], 2)
        fake = types.SimpleNamespace(log_dir=d, n_classes=2,
                                     _label_map=lambda: {"0": "Normal", "1": "Disease"})
        JTrainer._save_results(fake, agg, mode="test")
    (root / "DeepGraft" / "AttMIL" / "empty").mkdir(parents=True)
    return root


def test_scan_log_tree_equals_jax(log_tree):
    for kw in ({}, {"project": "deepgraft"}, {"model": "TransMIL", "task": "norm_rest"}):
        assert texport.scan_log_tree(log_tree, **kw) == jexport.scan_log_tree(log_tree, **kw)
    assert len(texport.scan_log_tree(log_tree)) == 4


def _copy_tree(src: Path, dst: Path) -> Path:
    import shutil

    shutil.copytree(src, dst)
    return dst


def test_export_combined_equals_jax(log_tree, tmp_path):
    outs = {}
    for name, mod in (("jax", jexport), ("port", texport)):
        root = _copy_tree(log_tree, tmp_path / name)
        runs = [r["dir"] for r in mod.scan_log_tree(root, project="DeepGraft")]
        mod.export_combined(runs + [str(root / "missing")], "norm_rest", 2,
                            tmp_path / f"{name}.csv")
        outs[name] = root
    mine = (tmp_path / "port.csv").read_text()
    theirs = (tmp_path / "jax.csv").read_text()
    assert mine == theirs.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    for d in sorted(outs["jax"].rglob("test_bootstrap.json")):
        rel = d.relative_to(outs["jax"])
        assert (outs["port"] / rel).read_text() == d.read_text()
    files = {name: sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                          if p.suffix in (".png", ".svg"))
             for name, root in outs.items()}
    assert files["port"] == files["jax"] and files["port"]
    for name in ("roc_comparison.png", "auroc_bars.png", "confusions.png", "pr_comparison.png"):
        assert (tmp_path / f"port_{name}").exists() and (tmp_path / f"jax_{name}").exists()


def test_export_metrics_cli_equals_jax(log_tree, tmp_path, capsys):
    for name, main in (("jax", jcli_export.main), ("port", tcli_export.main)):
        root = _copy_tree(log_tree, tmp_path / name)
        main(["--log_root", str(root), "--model", "TransMIL", "--task", "norm_rest",
              "--out_csv", str(tmp_path / f"{name}.csv")])
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "jax.csv").read_text().replace(str(tmp_path / "jax"),
                                                          str(tmp_path / "port")))
    with pytest.raises(SystemExit):
        tcli_export.main(["--out_csv", str(tmp_path / "none.csv")])


@pytest.mark.parametrize("name", ["train", "visualize", "infer", "extract_features",
                                  "sustainability", "export_metrics", "export_model", "serve",
                                  "pretrain"])
def test_entry_shims_resolve_to_the_port_clis(name, monkeypatch):
    """Each shim runs the port's CLI ``main`` and returns 0 (so
    ``sys.exit(shim())`` is a success whatever ``main`` returns), as JAX's."""
    cli = __import__(f"transmil_deepgraft_tpu_torch.cli.{name}", fromlist=["main"])
    calls = []
    monkeypatch.setattr(cli, "main", lambda: calls.append(1) or {"truthy": 1})
    assert getattr(_entry, name)() == 0 and calls == [1]


def test_step_timer_and_trace(tmp_path):
    mine, theirs = tprof.StepTimer(), jprof.StepTimer()
    assert mine.summary() == theirs.summary() == {}
    for _ in range(3):
        with mine, theirs:
            sum(range(1000))
    assert mine.summary().keys() == theirs.summary().keys()
    assert mine.summary()["steps"] == 3
    with tprof.trace(tmp_path / "prof") as d:
        np.ones(10).sum()
    assert (d / "trace.json").exists()
    json.loads((d / "trace.json").read_text())
