"""The UNI2-h slide cell (``slide-uni2h``) on the CPU at small widths: the
benchmark's copy of the plain reference agrees with the test suite's, the
ViT's operation count, the runner's check (``correct`` for the program,
false for each fault planted in the encoder the window runs) and the
cell's per-layer readers on a stub context. The control on the card is
the last test (``-m cuda``)."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import costs, harness, runners, weights_vit
from portbench.costs import vit as vit_costs
from portbench.reference import vit as bench_ref
from portbench.runners import slide_vit
from transmil_deepgraft_tpu_torch.models import backbones, vit
from transmil_deepgraft_tpu_torch.utils import profiling

CELL = "slide-uni2h"
ROOT = Path(__file__).resolve().parents[2]
SMALL = {"img_size": 32, "patch_size": 8, "embed_dim": 64, "depth": 2, "num_heads": 4,
         "mlp_ratio": 2.0, "reg_tokens": 2}
TINY_CONFIG = {"backbone": SMALL, "tile_hw": 32, "chunk": 4, "in_features": 64}
TINY_TRAFFIC = {"sizes": {"dist": "loguniform", "low": 5, "high": 14, "count": 4},
                "pool_tiles": 64, "check_tiles": 20}


def small_uni2h() -> vit.VisionTransformer:
    return vit.uni2_h(patch_size=8, dim=64, depth=2, heads=4, mlp_ratio=2.0, reg_tokens=2,
                      img_size=32)


@pytest.fixture
def tiny_uni2h(monkeypatch, cut):
    """``make(**cell fields)``: the cell cut to SMALL widths on the CPU, the
    port's ``uni2_h`` cut to the same."""
    monkeypatch.setattr(backbones, "uni2_h", small_uni2h)
    _, config, traffic = harness.cell_parts(CELL)

    def make(**kw):
        args = {"seed": 2 ** 31 + 23, "seconds": 0.5, "device": torch.device("cpu"), **kw}
        return runners.Cell(name=CELL, config=cut(config, TINY_CONFIG),
                            traffic=cut(traffic, TINY_TRAFFIC), **args)
    return make


def _suite_reference():
    """The test suite's copy, by path (a ``tests`` package installed
    elsewhere would shadow the repository's)."""
    path = ROOT / "tests" / "torch_ref" / "uni2h_torch.py"
    spec = importlib.util.spec_from_file_location("uni2h_torch_suite_copy", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_two_copies_of_the_reference_agree():
    suite_ref = _suite_reference()
    state = weights_vit.uni2h_state_dict(5, torch.device("cpu"), {**SMALL, "init_values": 1e-5})
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    models = []
    for mod in (suite_ref, bench_ref):
        m = mod.UNI2h(**SMALL)
        m.load_state_dict(state)
        models.append(m)
    for gemm in ("float32", "fp8"):
        a = suite_ref.forward_features(models[0], x, gemm)
        b = bench_ref.forward_features(models[1], x, gemm)
        assert torch.equal(a, b)
    u8 = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    assert torch.equal(suite_ref.normalize(u8), bench_ref.normalize(u8))


def test_the_seeded_weights_are_timm_named_and_drawn_from_the_seed():
    widths = {**SMALL, "init_values": 1e-5}
    a = weights_vit.uni2h_state_dict(9, torch.device("cpu"), widths)
    b = weights_vit.uni2h_state_dict(9, torch.device("cpu"), widths)
    assert a.keys() == bench_ref.UNI2h(**widths).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    gamma = a["blocks.1.ls2.gamma"]
    assert 0.5 < float(gamma.mean()) < 1.5 and float(gamma.std()) > 0.01  # order one
    assert float(a["reg_token"].std()) < 0.05
    p = weights_vit.transmil_params(9, torch.device("cpu"), 1536)
    assert p["fc1_0"]["kernel"].shape == (1536, 512) and "fc1_1" not in p


def test_uni2h_costs_370_94_gflop_a_tile():
    assert vit_costs.vit_tile_ops(224, **vit_costs.UNI2H) / 1e9 == pytest.approx(370.94, abs=0.01)
    # the MLP is ~65% of it and the attention products ~2.8%
    n, d = 265, 1536
    mlp = 24 * (2 * n * d * 8192 + 2 * n * 4096 * d)
    assert mlp / vit_costs.vit_tile_ops() == pytest.approx(0.648, abs=0.002)
    # TransMIL on 1536-d rows: fc1 is one 1536 -> 512 Dense
    assert vit_costs.transmil_ops(200) - costs.transmil_ops(200, 1536) == pytest.approx(
        2 * 200 * 1536 * 512 - 2 * 200 * (1536 * 768 + 768 * 512))


@pytest.mark.parametrize("plant", [None, *slide_vit.PLANTS])
def test_the_check_passes_the_program_and_fails_each_planted_fault(tiny_uni2h, plant):
    out = runners.run(tiny_uni2h(plant=plant))
    assert set(out.checks) == {"feature_gap", "logit_gap"}
    if plant is None:
        assert out.correct, out.checks
        assert out.metrics["slide_tiles_per_s"] > 0
    else:
        assert not out.correct, out.checks


def test_the_window_times_whole_blocks_and_checks_its_shortest_slide(tiny_uni2h):
    cell = tiny_uni2h()
    out = runners.run(cell)
    slides, block = out.work["slides"], cell.traffic["sizes"]["count"]
    assert slides and len(slides) % block == 0
    checked = out.work["checked"]
    assert min(slides) in checked and sum(checked) <= cell.traffic["check_tiles"]


def test_a_planted_fault_name_must_be_known(tiny_uni2h):
    with pytest.raises(ValueError, match="unknown fault"):
        runners.run(tiny_uni2h(plant="answer"))


@pytest.fixture
def registry():
    profiling.REGISTRY.reset()
    yield profiling.REGISTRY
    profiling.REGISTRY.reset()


WORK = {"slides": [200, 300], "chunk": 128, "hw": 224, "in_features": 1536,
        "backbone": dict(vit_costs.UNI2H)}


def _ctx(work, busy_s=0.0):
    view = SimpleNamespace(window_s=2.0, busy_s=busy_s)
    return SimpleNamespace(trace=view, work=work, config={}, costs=costs, cell=CELL)


def test_the_cells_readers_read_a_stub_context(registry):
    # 5 chunks; stream times differ from host times, so a reader of the
    # wrong one reads another number
    registry.add_span("vit.attn", 9.0, 0.050, 240)
    registry.add_span("vit.mlp", 9.0, 0.100, 240)
    read = lambda m, ctx: harness.reader(m)(ctx)  # noqa: E731
    assert read("slide_uni2h.attn_ms_per_chunk", _ctx(WORK)) == pytest.approx(10.0)
    assert read("slide_uni2h.mlp_ms_per_chunk", _ctx(WORK)) == pytest.approx(20.0)
    flt = 500 * 370.940461056e9 + vit_costs.transmil_ops(200) + vit_costs.transmil_ops(300)
    assert read("mfu.slide_uni2h", _ctx(WORK)) == pytest.approx(100 * flt / 989e12 / 2.0)
    assert read("device_idle.slide_uni2h", _ctx(WORK, busy_s=1.5)) == pytest.approx(25.0)
    man = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in ("mfu.slide_uni2h", "slide_uni2h.attn_ms_per_chunk",
                 "slide_uni2h.mlp_ms_per_chunk", "device_idle.slide_uni2h"):
        assert man[name]["workloads"] == [CELL] and man[name]["moves"] == "slide_tiles_per_s"


def test_the_cells_readers_return_nothing_without_their_spans_or_slides(registry):
    empty = {**WORK, "slides": []}
    for name in ("slide_uni2h.attn_ms_per_chunk", "slide_uni2h.mlp_ms_per_chunk",
                 "mfu.slide_uni2h"):
        assert harness.reader(name)(_ctx(WORK if "ms" in name else empty)) is None
    # the parent's work for another runner has no "backbone"
    parent = {k: v for k, v in WORK.items() if k != "backbone"}
    assert harness.reader("mfu.slide_uni2h")(_ctx(parent)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["program", "control"])
def test_the_fp8_control_fails_where_the_program_passes(cuda_device, cut, side):
    """At the published widths on the card, slides of 512-1,024 tiles."""
    _, config, traffic = harness.cell_parts(CELL)
    small = {"sizes": {"dist": "loguniform", "low": 512, "high": 1024, "count": 2},
             "pool_tiles": 2048, "check_tiles": 1024}
    cell = runners.Cell(name=CELL, config=config, traffic=cut(traffic, small),
                        seed=2 ** 31 + 101, seconds=1.0, device=cuda_device, side=side)
    out = runners.run(cell)
    assert out.correct == (side == "program"), out.checks
