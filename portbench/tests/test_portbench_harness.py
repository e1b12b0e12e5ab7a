"""The harness's refusals and its imports: no result without a card, and
nothing the harness runs loads JAX or the JAX package (top-level names
compared whole); the reference loads nothing of the port either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "transmil_deepgraft_tpu"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "slide-mixed", "--seed", str(2 ** 31 + 3), "--seconds",
                       "1", "--trace", "0"], 0.0)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = harness.main(["--workload", "train-b64x200", "--seed", "1", "--seconds", "1",
                       "--trace", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_the_command_fails_and_prints_nothing(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's paths."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run([sys.executable, *man["command"][1:], "--workload", "slide-mixed",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _imported_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT) for p in BENCH.rglob("*.py")),
                         ids=str)
def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imported_names(ROOT / path)}
    assert not tops & FORBIDDEN
    if path.parts[1] == "reference":
        assert "transmil_deepgraft_tpu_torch" not in tops


def _loaded_after(code: str) -> set[str]:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
             "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_and_runners_load_neither_jax_nor_the_jax_package():
    loaded = _loaded_after(
        "import portbench.harness, portbench.runners.slide, portbench.runners.train; "
        "import transmil_deepgraft_tpu_torch.inference, "
        "transmil_deepgraft_tpu_torch.serving, transmil_deepgraft_tpu_torch.train.trainer")
    assert "transmil_deepgraft_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import portbench.reference.resnet_int8, "
                           "portbench.reference.transmil, portbench.reference.radam")
    assert not loaded & (FORBIDDEN | {"transmil_deepgraft_tpu_torch"})


def test_the_result_line_refuses_a_process_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "transmil_deepgraft_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
