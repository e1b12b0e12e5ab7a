"""The trace reduction and the per-layer readers on a small recorded trace:
kineto-shaped events of one window with known kernels, copies and gaps."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import costs, harness, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start_us, dur_us, device=CUDA):
        self._n, self._s, self._d, self._dev = name, int(start_us * 1e3), int(dur_us * 1e3), device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


# a 10 ms window (1,000-11,000 us): copies, a torch op, the int8 stage
# kernels, the landmark and TransLayer kernels, and a 3 ms idle gap while
# the host waits in a copy call
RECORDED = [
    Event("portbench.window", 1000, 10000, CPU),
    Event("portbench.slide.predict", 1000, 10000, CPU),
    Event("cudaMemcpyAsync", 6900, 3100, CPU),
    Event("Memcpy HtoD (Pageable -> Device)", 900, 600),  # starts before the window
    Event("void at::native::elementwise_kernel<128, 4>(int, float)", 1500, 1000),
    Event("void conv_kernel<64, 32, 1>(ConvArgs)", 2500, 2000),
    Event("void conv_kernel<128, 64, 2>(ConvArgs)", 4000, 1000),  # overlaps the one before
    Event("Memcpy HtoD (Pageable -> Device)", 5000, 500),
    Event("Memset (Device)", 5500, 100),
    Event("void landmark_attn_kernel<true>(float const*)", 5600, 400),
    Event("void gemm_kernel<0>(GemmArgs)", 6000, 1000),
    Event("void query_lm_kernel(float const*)", 10000, 500),
    Event("void ln_stats_kernel(float const*, float*, int)", 10500, 600),  # runs past the end
]


def view():
    return trace.reduce_events(RECORDED)


def test_the_window_clips_device_time_and_finds_busy_and_idle():
    v = view()
    assert v.window_s == pytest.approx(0.010)
    # busy 1000-7000 (the copy clipped at 1000, the convs overlapping) and
    # 10000-11000 (the last kernel clipped); idle 7000-10000 in the copy call
    assert v.busy_s == pytest.approx(7e-3)
    assert v.gaps == pytest.approx({"slide.predict / cudaMemcpyAsync": 3e-3})


def test_port_kernels_copies_and_torch_ops_are_told_apart():
    v = view()
    assert v.total_s(lambda n: trace.is_port(n, "qstage")) == pytest.approx(3e-3)
    assert v.total_s(lambda n: trace.is_port(n, "nystrom")) == pytest.approx(0.9e-3)
    assert v.total_s(lambda n: trace.is_port(n, "translayer")) == pytest.approx(1.5e-3)
    assert v.total_s(lambda n: trace.is_copy(n, "HtoD")) == pytest.approx(1.0e-3)
    assert v.total_s(trace.is_torch_op) == pytest.approx(1.0e-3)
    ops = dict(map(tuple, v.breakdown()["device_ops"]))
    assert ops["conv_kernel<64, 32, 1>(ConvArgs)"] == pytest.approx(2e-3)


def ctx(work, cell):
    return SimpleNamespace(trace=view(), work=work, costs=costs, config={}, cell=cell)


def test_slide_readers():
    work = {"slides": [200], "chunk": 128, "hw": 224, "in_features": 2048}
    read = lambda m: harness.reader(m)(ctx(work, "slide-mixed"))  # noqa: E731
    assert read("slide.h2d_ms_per_chunk") == pytest.approx(0.5)
    assert read("slide.torch_ops_ms_per_chunk") == pytest.approx(0.5)
    least = costs.qstage_least_s(128) + costs.qstage_least_s(72)
    assert read("roofline.qstage.slide") == pytest.approx(100 * least / 3e-3)
    mfu = costs.ops_s(200 * costs.r50_tile_ops(), costs.transmil_ops(200)) / 0.010
    assert read("mfu.slide") == pytest.approx(100 * mfu)
    assert read("roofline.translayer.slide") == pytest.approx(
        100 * costs.translayer_least_s(200) / 2.4e-3)
    assert read("device_idle.slide") == pytest.approx(30.0)


def test_train_readers():
    work = {"steps": 1, "micro_steps": 2, "batch": 64, "bag": 200, "in_features": 2048}
    read = lambda m, w, c: harness.reader(m)(ctx(w, c))  # noqa: E731
    least = 2 * 2 * costs.nystrom_least_s(64, 256)
    assert read("roofline.nystrom.train", work, "train-b64x200") == pytest.approx(
        100 * least / 0.9e-3)
    assert read("train.torch_ops_ms_per_step", work, "train-b64x200") == pytest.approx(1.0)
    mfu = 3 * 2 * 64 * costs.transmil_ops(200) / 989e12 / 0.010
    assert read("mfu.train", work, "train-b64x200") == pytest.approx(100 * mfu)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = trace.reduce_events(RECORDED[:3])
    c = SimpleNamespace(trace=empty, costs=costs, config={}, cell="x",
                        work={"slides": [], "chunk": 128, "hw": 224, "in_features": 2048,
                              "steps": 0, "micro_steps": 0, "batch": 64, "bag": 200})
    for m in ("roofline.qstage.slide", "roofline.nystrom.train", "roofline.translayer.slide",
              "mfu.slide", "mfu.train", "slide.h2d_ms_per_chunk", "slide.torch_ops_ms_per_chunk",
              "train.torch_ops_ms_per_step"):
        assert harness.reader(m)(c) is None, m
