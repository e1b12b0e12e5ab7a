"""The readers of the program's spans and counters
(``transmil_deepgraft_tpu_torch.utils.profiling``) on a registry filled by
hand: each gives its number from the span or counter it names, and nothing
where the registry lacks it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import costs, harness
from transmil_deepgraft_tpu_torch.utils import profiling

SLIDE = {"slides": [200, 300], "chunk": 128, "hw": 224, "in_features": 2048}
TRAIN = {"steps": 4, "micro_steps": 8, "batch": 64, "bag": 200, "in_features": 2048}
# reader -> (its cell's work, the expected number)
EXPECTED = {
    "slide.stem_ms_per_chunk": (SLIDE, 6.0),  # 30 ms of stream time over 5 calls
    "slide.copy_host_ms_per_chunk": (SLIDE, 10.0),  # 50 ms of host time over 5 calls
    "slide.device_allocs_per_slide": (SLIDE, 3.5),  # 7 over 2 slides
    "train.forward_ms_per_step": (TRAIN, 20.0),
    "train.backward_ms_per_step": (TRAIN, 30.0),
    "train.update_ms_per_step": (TRAIN, 5.0),
    "train.pinv_ms_per_step": (TRAIN, 8.0),
    "train.readback_ms_per_step": (TRAIN, 0.5),  # stream time: 2 ms over 4 steps
    "train.input_wait_ms_per_step": (TRAIN, 0.25),
}


@pytest.fixture
def registry():
    profiling.REGISTRY.reset()
    yield profiling.REGISTRY
    profiling.REGISTRY.reset()


def _fill(reg) -> None:
    # (name, calls, host_s, device_s); host and stream times differ, so a
    # reader of the wrong one reads another number
    for name, calls, host_s, device_s in (
            ("backbone.stem", 5, 0.9, 0.030), ("slide.copy", 5, 0.050, 0.012),
            ("train.forward", 8, 0.5, 0.080), ("train.backward", 8, 0.5, 0.120),
            ("train.update", 8, 0.5, 0.020), ("pinv", 16, 0.5, 0.032),
            ("train.readback", 8, 0.006, 0.002), ("data.wait", 8, 0.001, 0.0)):
        reg.add_span(name, host_s, device_s, calls)
    reg.count("slide.device_allocs", 7)


def _ctx(work):
    return SimpleNamespace(trace=None, work=work, config={}, costs=costs, cell="x")


def test_every_new_reader_is_in_the_manifest_for_its_cell():
    man = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name, (work, _) in EXPECTED.items():
        cell = "slide-mixed" if work is SLIDE else "train-b64x200"
        assert man[name]["workloads"] == [cell]
        assert man[name]["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_gives_its_number_from_the_registry(registry, name):
    _fill(registry)
    work, want = EXPECTED[name]
    assert harness.reader(name)(_ctx(work)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_of_an_empty_registry_returns_nothing(registry, name):
    assert harness.reader(name)(_ctx(EXPECTED[name][0])) is None
