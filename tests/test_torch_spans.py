"""The port's spans and counters (``utils/profiling``).

On the CPU: with no profiler a span is the shared no-op and records
nothing; under ``torch.profiler`` its name is among the profiler's events
and the registry counts its calls and host time; each profiled region
starts from zero; sixteen threads lose no update; ``newton_schulz_pinv``,
``Trainer.train_step`` on a tiny TransMIL and ``embed_chunk`` record their
spans. On the card (``-m cuda``,
this file imports no JAX): a span's stream time covers the device's work,
and a span costs under a microsecond while no profiler runs:

    python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda
"""

import sys
import tempfile
import threading
import time
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from transmil_deepgraft_tpu_torch.utils import profiling

CPU = [ProfilerActivity.CPU]


def _event_names(prof) -> set:
    return {e.name for e in prof.events()}


def test_without_a_profiler_a_span_records_nothing():
    before = profiling.snapshot()
    assert not profiling.enabled()
    with profiling.span("test.off") as s:
        time.sleep(0.001)
    profiling.count("test.off_count")
    assert s is None  # the shared no-op
    assert profiling.span("test.off") is profiling.span("test.other")
    assert profiling.snapshot() == before


def test_the_gate_is_the_profilers_own_flag(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert profiling.enabled() and profiling.span("test.flag") is not profiling.span("test.flag")
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    assert not profiling.enabled()


def test_a_profiled_region_records_names_calls_and_host_time():
    with profile(activities=CPU) as prof:
        assert profiling.enabled()
        for _ in range(3):
            with profiling.span("test.on"):
                time.sleep(0.002)
        profiling.count("test.items", 5)
        profiling.count("test.items")
    assert not profiling.enabled()
    assert "tdg.test.on" in _event_names(prof)
    snap = profiling.snapshot()
    on = snap["spans"]["test.on"]
    assert on["calls"] == 3 and on["host_s"] >= 0.006 and on["device_s"] == 0.0
    assert snap["counters"] == {"test.items": 6}

    with profile(activities=CPU):  # a second region starts from zero
        with profiling.span("test.again"):
            pass
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"test.again"} and snap["counters"] == {}


def test_spans_from_many_threads_lose_no_update():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with profiling.span("test.thread"):
                    pass
                profiling.count("test.thread_items", 2)

        with profile(activities=CPU):
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = profiling.snapshot()
    assert snap["spans"]["test.thread"]["calls"] == 16 * 200
    assert snap["counters"]["test.thread_items"] == 16 * 200 * 2


def test_pinv_train_step_and_embed_chunk_record_their_spans():
    from transmil_deepgraft_tpu_torch.inference import embed_chunk
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.ops.pinv import newton_schulz_pinv
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.manual_seed(0)
    model = create_model("TransMIL", 2, 16, 32, device="cpu", use_pallas=True)
    tx = create_optimizer("radam", lr=1e-4, weight_decay=0.01, grad_accum_steps=1)
    tx.init(model)
    bags, labels = torch.randn(2, 20, 16), torch.tensor([0, 1])
    mean, std = torch.zeros(3), torch.ones(3)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, tx, None, n_classes=2, loss_fn=create_loss("CrossEntropyLoss"),
                          config=TrainerConfig(seed=0, log_dir=tmp), model_name="TransMIL")
        with profile(activities=CPU) as prof:
            newton_schulz_pinv(torch.eye(4) + 0.1 * torch.rand(4, 4))
            loss, probs = trainer.train_step(bags, labels)
            embed_chunk(lambda x: x.mean(dim=(1, 2)), np.zeros((2, 4, 4, 3), np.uint8), mean, std)
    assert np.isfinite(loss) and probs.shape == (2, 2)
    spans = profiling.snapshot()["spans"]
    parts = ("train.forward", "train.backward", "train.update", "train.readback")
    for name in parts + ("slide.copy",):
        assert spans[name]["calls"] == 1, name
    # the direct call and one a TransLayer in the forward; the analytic
    # backward's recompute is not the pinv span's
    assert spans["pinv"]["calls"] == 3
    assert {f"tdg.{n}" for n in parts + ("pinv", "slide.copy")} <= _event_names(prof)


@pytest.mark.cuda
def test_a_span_reads_stream_time_and_costs_under_a_microsecond_off():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: stream time is read from CUDA events")
    torch.cuda.init()
    cycles = int(5e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)  # ~5 ms
    with profile(activities=CPU + [ProfilerActivity.CUDA]):
        for _ in range(3):
            with profiling.span("test.sleep"):
                torch.cuda._sleep(cycles)
    s = profiling.snapshot()["spans"]["test.sleep"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    slept_s = start.elapsed_time(end) / 1e3
    assert s["calls"] == 3 and s["device_s"] >= 3 * 0.95 * slept_s, (s, slept_s)

    x = torch.zeros(1, device="cuda")
    n_spans = 3 * profiling.MAX_PENDING  # resolved in batches
    with profile(activities=CPU + [ProfilerActivity.CUDA]):
        for _ in range(n_spans):
            with profiling.span("test.many"):
                x.add_(1)
    many = profiling.snapshot()["spans"]["test.many"]
    assert many["calls"] == n_spans and 0 < many["device_s"] < many["host_s"] + 1, many
    assert x.item() == n_spans

    def off():
        with profiling.span("test.off"):
            pass

    n = 100_000
    per_span_s = min(timeit.repeat(off, number=n, repeat=5)) / n
    assert per_span_s < 1e-6, per_span_s
