"""The port's serving daemon (``cli/serve``) at ``GET /metrics``: the
MicroBatcher's queue wait, bags a dispatch and sheds, on the CPU over an
AttMIL bundle with one bucket (64) that the JAX package exports."""

from __future__ import annotations

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from transmil_deepgraft_tpu.models import create_model
from transmil_deepgraft_tpu.serving import export_serving_bundle
from transmil_deepgraft_tpu_torch.cli.serve import _Metrics, make_server
from transmil_deepgraft_tpu_torch.serving import MicroBatcher, QueueFullError, ServingBundle

DIM = 32


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    model = create_model("AttMIL", n_classes=3, in_features=DIM)
    x = np.zeros((1, 64, DIM), np.float32)
    variables = jax.device_get(model.init({"params": jax.random.key(0)}, x))
    path = tmp_path_factory.mktemp("bundle") / "head_shed.tdx"
    export_serving_bundle(
        model, variables, path, model_name="AttMIL", in_features=DIM,
        buckets=(64,), platforms=("cpu",),
    )
    return ServingBundle.load(path, device="cpu")


def _metric(text: str, name: str) -> float:
    return float(next(line for line in text.splitlines()
                      if line.startswith(name + " ")).rsplit(" ", 1)[1])


def test_port_metrics_show_queue_wait_and_dispatch_bags(bundle):
    """Every /predict bag's queue wait (enqueue to the start of its
    dispatch) in a histogram of the request buckets, and the bags a
    dispatch, at GET /metrics."""
    srv = make_server(bundle, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        feats = np.random.default_rng(3).standard_normal((2, 30, DIM)).astype(np.float32)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/predict", body=json.dumps({"bags": feats.tolist()}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        status, doc = r.status, json.loads(r.read())
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 200 and len(doc["logits"]) == 2
    assert "# TYPE transmil_queue_wait_seconds histogram" in text
    assert _metric(text, 'transmil_queue_wait_seconds_bucket{le="+Inf"}') == 2
    assert _metric(text, "transmil_queue_wait_seconds_count") == 2
    assert _metric(text, "transmil_queue_wait_seconds_sum") >= 0
    assert _metric(text, "transmil_dispatch_bags_sum") == 2
    assert 1 <= _metric(text, "transmil_dispatch_bags_count") <= 2
    assert _metric(text, "transmil_shed_total") == 0


def test_port_metrics_count_the_sheds(bundle):
    """With the dispatcher blocked (device lock held), the request beyond
    max_queue is shed and counted at /metrics, and the admitted ones' queue
    waits cover the 30 ms the device was held."""
    device_lock = threading.Lock()
    mb = MicroBatcher(bundle, max_wait_ms=1.0, device_lock=device_lock, max_queue=2)
    bag = np.random.default_rng(11).standard_normal((30, DIM)).astype(np.float32)
    try:
        with device_lock:  # a slow device: the dispatcher blocks
            futures = [mb._enqueue(bag, None) for _ in range(2)]
            with pytest.raises(QueueFullError):
                mb._enqueue(bag, None)
            time.sleep(0.03)
        for f in futures:
            assert f.result(timeout=30).shape == (3,)
        text = _Metrics(mb).render()
    finally:
        mb.close()
    assert _metric(text, "transmil_shed_total") == 1
    assert _metric(text, "transmil_queue_wait_seconds_count") == 2
    assert _metric(text, 'transmil_queue_wait_seconds_bucket{le="0.025"}') == 0
    assert _metric(text, "transmil_dispatch_bags_sum") == 2
