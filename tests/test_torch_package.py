"""Package rules of the port: it imports neither JAX nor the JAX package, its
CUDA sources include no PyTorch header, its entry points run on the card
unless the CPU is asked for, and ``chip_smoke.py`` fails without a card."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu_torch.device import resolve_device
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.ops import _build
from transmil_deepgraft_tpu_torch.serving import ServingBundle, export_serving_bundle

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "transmil_deepgraft_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_importing_the_port_leaves_jax_out():
    """tests/conftest.py imports JAX, so the check runs in a fresh process."""
    code = (
        "import sys\n"
        f"for m in {MODULES!r}: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'transmil_deepgraft_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_port_sources_name_no_jax_import(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|transmil_deepgraft_tpu)\b", text, re.M)


def test_cuda_sources_include_no_pytorch_header():
    sources = list((PORT / "csrc").glob("*.cu*"))
    assert sources
    for src in sources:
        includes = re.findall(r"#include\s*[<\"]([^>\"]+)", src.read_text())
        assert not [i for i in includes if i.startswith(("torch", "ATen", "c10", "pybind11"))]


def test_nvcc_build_targets_sm90a_into_the_build_dir():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    so = _build.library_path("translayer")
    assert so.name == "libtranslayer.so"
    assert so.parent.parent == REPO / "build" / "torch_kernels"
    assert set(_build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    assert resolve_device("cpu") == torch.device("cpu")
    model = create_model("TransMIL", 2, 384, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("TransMIL", 2, 384)
    rng = np.random.default_rng(0)
    from transmil_deepgraft_tpu.utils.torch_weights import convert_transmil_state_dict

    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in model.state_dict().items()}
    export_serving_bundle(convert_transmil_state_dict(sd, 384)["params"], tmp_path / "b.tdx",
                          model_name="TransMIL", in_features=384, n_classes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingBundle.load(tmp_path / "b.tdx")
    assert ServingBundle.load(tmp_path / "b.tdx", device="cpu").device.type == "cpu"

    # a slide bundle (bf16: no calibration; the ResNet50 cut after layer1,
    # 256-d features), the daemon and the slide CLI
    import chip_smoke
    from transmil_deepgraft_tpu_torch.cli import infer, serve
    from transmil_deepgraft_tpu_torch.serving import export_slide_bundle

    head = create_model("TransMIL", 2, 256, device="cpu").state_dict()
    head_params = convert_transmil_state_dict(head, 256)["params"]
    backbone = chip_smoke.random_resnet50_variables(rng)
    export_slide_bundle(backbone, head_params, tmp_path / "s.tdx", model_name="TransMIL",
                        in_features=256, n_classes=2, chunk=2, tile_hw=32, truncate_after=1)
    with pytest.raises(ValueError, match="in_features=384"):
        export_slide_bundle(backbone, head_params, tmp_path / "x.tdx", model_name="TransMIL",
                            in_features=384, n_classes=2, truncate_after=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingBundle.load(tmp_path / "s.tdx")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--bundle", str(tmp_path / "b.tdx"), "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--tiles_root", str(tmp_path), "--backbone_ckpt", "bb.pth",
                    "--head_ckpt", "head.pth", "--out_dir", str(tmp_path / "out")])


@pytest.mark.parametrize("alone", [False, True], ids=["no_card", "script_alone"])
def test_chip_smoke_fails_without_a_card_or_the_port(alone, tmp_path):
    """Hidden from any card, and copied alone out of the checkout, the smoke
    run exits non-zero and prints no result."""
    script = REPO / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        env.pop("CUDA_VISIBLE_DEVICES")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
