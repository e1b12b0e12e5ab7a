"""The manifest and the files it names: found by name, within the allowed
characters and sizes, and extended by adding files and entries alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = harness.manifest()


def test_manifest_has_the_required_keys_and_no_others():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
    assert any(w.startswith("portbench/") for w in MAN["command"])
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_one_line_texts_use_the_allowed_characters(kind):
    entries = MAN[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_every_cell_finds_its_configuration_traffic_and_metrics_by_name():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        work, config, traffic = harness.cell_parts(w["name"])
        assert config["name"] == w["config"] and "runner" in traffic
        ends = {m["name"] for m in harness.cell_metrics(w["name"], "end_to_end")}
        assert "setup_s" in ends and len(ends) >= 2 and ends <= e2e
        layer = harness.cell_metrics(w["name"], "per_layer")
        assert layer and all(m["moves"] in ends for m in layer)
        for m in layer:
            assert callable(harness.reader(m["name"]))
    for c in MAN["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_a_cell_configuration_and_metric_are_added_as_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric by new files and manifest entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    base = json.loads((ROOT / "portbench/configs/retccl-r50-int8-transmil.json").read_text())
    (tmp_path / "portbench/configs/retccl-r50-int8-transmil-3cls.json").write_text(
        json.dumps({**base, "name": "retccl-r50-int8-transmil-3cls", "n_classes": 3}))
    small = json.loads((ROOT / "portbench/traffic/slides-loguniform.json").read_text())
    small["sizes"] = {**small["sizes"], "low": 512, "high": 4096}
    (tmp_path / "portbench/traffic/slides-biopsy.json").write_text(json.dumps(small))
    (tmp_path / "portbench/metrics/slide.chunks_per_slide.py").write_text(
        "def read(ctx):\n    return 1.0 if ctx.work.get('slides') else None\n")
    man["configs"].append({"name": "retccl-r50-int8-transmil-3cls", "source": "https://example.org/p",
                           "file": "portbench/configs/retccl-r50-int8-transmil-3cls.json",
                           "reduced": [], "why": "a three-class task"})
    man["workloads"].append({"name": "slide-biopsy", "config": "retccl-r50-int8-transmil-3cls",
                             "traffic": "slides-biopsy", "chips": 1, "why": "biopsies alone"})
    for m in man["end_to_end"]:
        if m["name"] == "slide_tiles_per_s":
            m["workloads"].append("slide-biopsy")
    man["per_layer"].append({"name": "slide.chunks_per_slide", "unit": "1", "better": "lower",
                             "source": "device_trace", "layer": "slide pipeline",
                             "moves": "slide_tiles_per_s", "workloads": ["slide-biopsy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    work, config, traffic = harness.cell_parts("slide-biopsy", tmp_path)
    assert config["n_classes"] == 3 and traffic["sizes"]["high"] == 4096
    assert traffic["runner"] == "slide"
    names = [m["name"] for m in harness.cell_metrics("slide-biopsy", "per_layer", tmp_path)]
    assert names == ["slide.chunks_per_slide"]
    ends = [m["name"] for m in harness.cell_metrics("slide-biopsy", "end_to_end", tmp_path)]
    assert ends == ["slide_tiles_per_s", "setup_s"]
    read = harness.reader("slide.chunks_per_slide", tmp_path)
    assert read(type("Ctx", (), {"work": {"slides": [1]}})()) == 1.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file() and
             p.relative_to(tmp_path) in before}
    assert after == before  # no file that was there changed
