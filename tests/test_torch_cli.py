"""The port's command-line entry points against the JAX package's.

``cli.serve``: the port's daemon serves a TransMIL bundle the JAX package
exported and answers every case of tests/test_cli_serve.py (health and meta,
JSON, ``.npy`` and ``.npz`` bodies, 404, 400, 503 + Retry-After, /metrics),
with logits within 1e-3 (the PARITY.md bar) of the JAX daemon's on the same
bundle. ``cli.export_model`` writes head and slide bundles that
``ServingBundle.load`` reads, and the daemon serves the slide bundle's
``/predict_slide``. ``cli.infer`` on 2 slides x 6 JPEG tiles with ``.pth``
checkpoints gives probabilities within 1e-3 of JAX's ``cli.infer`` on the
same files and the same top-k tiles wherever JAX's scores are separated."""

import csv
import http.client
import io
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import torchvision_state_dict
from tests.test_torch_resnet import perturbed_resnet_variables
from transmil_deepgraft_tpu.cli.serve import make_server as jax_make_server
from transmil_deepgraft_tpu.models import TransMIL as JaxTransMIL
from transmil_deepgraft_tpu.serving import ServingBundle as JaxBundle
from transmil_deepgraft_tpu.serving import export_serving_bundle as jax_export_serving_bundle
from transmil_deepgraft_tpu_torch.cli import export_model, infer
from transmil_deepgraft_tpu_torch.cli.serve import make_server, warmup
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.serving import ServingBundle

DIM, N_CLASSES, BUCKETS, TOL = 64, 3, (64, 128), 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread is faster on a loaded CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _serve(bundle, make=make_server, **kwargs):
    srv = make(bundle, "127.0.0.1", 0, **kwargs)  # ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _request(port, method, path, body=None, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers={"Content-Type": ctype} if body else {})
    r = conn.getresponse()
    out = json.loads(r.read())
    headers = dict(r.getheaders())
    conn.close()
    return r.status, out, headers


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's daemon and the JAX daemon on one JAX-exported TransMIL
    bundle; yields (port's port, JAX's port, the port's bundle)."""
    head = JaxTransMIL(n_classes=N_CLASSES, in_features=DIM, out_features=32)
    variables = jax.device_get(head.init({"params": jax.random.key(0)}, jnp.zeros((1, 64, DIM))))
    path = tmp_path_factory.mktemp("bundle") / "head.tdx"
    jax_export_serving_bundle(head, variables, path, model_name="TransMIL", in_features=DIM,
                              buckets=BUCKETS, platforms=("cpu",), attention=False)
    bundle = ServingBundle.load(path, device="cpu")
    ours, theirs = _serve(bundle), _serve(JaxBundle.load(path), jax_make_server)
    yield ours.server_address[1], theirs.server_address[1], bundle
    _stop(ours)
    _stop(theirs)


def _bag(n, seed):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def test_health_and_meta(servers):
    port, _, _ = servers
    status, doc, _ = _request(port, "GET", "/health")
    assert status == 200 and doc["status"] == "ok" and doc["model"] == "TransMIL"
    assert doc["buckets"] == list(BUCKETS) and doc["queue_depth"] == 0
    status, meta, _ = _request(port, "GET", "/meta")
    assert status == 200 and meta["in_features"] == DIM and meta["n_classes"] == N_CLASSES


@pytest.mark.parametrize("body", ["json", "npy", "npz"])
def test_predict_matches_the_jax_daemon(servers, body):
    port, jax_port, _ = servers
    feats = np.stack([_bag(40, 1), _bag(40, 2)]) if body == "npy" else _bag(40, 0)
    if body == "json":
        payload, ctype = json.dumps({"features": feats.tolist()}), "application/json"
    elif body == "npy":
        payload, ctype = _npy(feats), "application/octet-stream"
    else:
        buf = io.BytesIO()
        np.savez(buf, features=feats)
        payload, ctype = buf.getvalue(), "application/octet-stream"
    status, doc, _ = _request(port, "POST", "/predict", payload, ctype)
    j_status, want, _ = _request(jax_port, "POST", "/predict", payload, ctype)
    assert status == j_status == 200
    assert np.asarray(doc["logits"]).shape == (len(feats) if body == "npy" else 1, N_CLASSES)
    np.testing.assert_allclose(doc["logits"], want["logits"], atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(doc["probs"]).sum(-1), 1.0, rtol=1e-5)
    assert doc["pred"] == want["pred"]


def test_bad_requests_are_400_and_unknown_paths_404(servers):
    port, _, _ = servers
    for payload, ctype in ((b"not json", "application/json"),
                           (json.dumps({"features": [1.0, 2.0]}), "application/json"),
                           (_npy(_bag(DIM + 100, 0)[:, :DIM - 1]), "application/octet-stream")):
        status, doc, _ = _request(port, "POST", "/predict", payload, ctype)
        assert status == 400 and "error" in doc
    buf = io.BytesIO()
    np.savez(buf, features=_bag(40, 0), coords=np.zeros((40, 2), np.float32))
    status, doc, _ = _request(port, "POST", "/predict", buf.getvalue(), "application/octet-stream")
    assert status == 400 and "not coord-aware" in doc["error"]
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "POST", "/nope", b"{}")[0] == 404


def test_malformed_content_length_is_400_and_counted(servers):
    port, _, _ = servers
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: abc\r\nConnection: close\r\n\r\n")
        resp = b""
        while chunk := s.recv(4096):
            resp += chunk
    assert b" 400 " in resp.split(b"\r\n", 1)[0]
    assert _request(port, "GET", "/health")[0] == 200


def test_concurrent_predicts_are_consistent(servers):
    port, _, bundle = servers
    bags = [_bag(40 + i, 10 + i) for i in range(6)]
    with ThreadPoolExecutor(max_workers=6) as ex:
        results = list(ex.map(
            lambda b: _request(port, "POST", "/predict", _npy(b), "application/octet-stream"), bags))
    for bag, (status, doc, _) in zip(bags, results):
        assert status == 200
        np.testing.assert_allclose(doc["logits"], bundle.predict_logits(bag), atol=1e-6, rtol=0)


def test_metrics_count_the_requests(servers):
    port, _, _ = servers
    _request(port, "POST", "/predict", json.dumps({"features": _bag(30, 7).tolist()}))
    _request(port, "POST", "/predict", b"garbage")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    r = conn.getresponse()
    text = r.read().decode()
    conn.close()
    assert r.status == 200 and r.headers["Content-Type"].startswith("text/plain")
    counts = {line.split("}")[0] + "}": int(line.rsplit(" ", 1)[1])
              for line in text.splitlines() if line.startswith("transmil_requests_total{")}
    assert counts['transmil_requests_total{endpoint="/predict",status="200"}'] >= 1
    assert counts['transmil_requests_total{endpoint="/predict",status="400"}'] >= 1
    lines = text.splitlines()
    inf = [x for x in lines if x.startswith(
        'transmil_request_seconds_bucket{endpoint="/predict",le="+Inf"}')]
    cnt = [x for x in lines if x.startswith('transmil_request_seconds_count{endpoint="/predict"}')]
    assert inf and cnt and inf[0].rsplit(" ", 1)[1] == cnt[0].rsplit(" ", 1)[1]
    assert "transmil_uptime_seconds" in text


def test_server_sheds_503_with_retry_after(servers, monkeypatch):
    """A slowed device and max_queue 1: a burst of six gets 200s and 503s
    with Retry-After, and the server accepts again once the burst drains."""
    _, _, bundle = servers
    logits = bundle._logits

    def slow(*args):
        time.sleep(0.25)
        return logits(*args)

    monkeypatch.setattr(bundle, "_logits", slow)
    srv = _serve(bundle, max_queue=1)
    port = srv.server_address[1]
    body = json.dumps({"features": _bag(30, 3).tolist()})
    try:
        with ThreadPoolExecutor(max_workers=6) as ex:
            results = list(ex.map(lambda _: _request(port, "POST", "/predict", body), range(6)))
        statuses = [s for s, _, _ in results]
        assert 200 in statuses and 503 in statuses, statuses
        for status, doc, headers in results:
            if status == 503:
                assert int(headers["Retry-After"]) >= 1
                assert doc["queue_depth"] >= 1 and "retry_after_s" in doc
        status, doc, _ = _request(port, "GET", "/health")
        assert status == 200 and doc["max_queue"] == 1
        assert _request(port, "POST", "/predict", body)[0] == 200
    finally:
        _stop(srv)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A ResNet50 and a TransMIL (out_features 32) as .pth files, and
    2 slides x 6 JPEG tiles of 64x64 named tile_(x-y).jpg."""
    root = tmp_path_factory.mktemp("infer")
    torch.save(torchvision_state_dict(perturbed_resnet_variables(5)), root / "backbone.pth")
    rng = np.random.default_rng(6)
    model = create_model("TransMIL", 2, 2048, 32, device="cpu")
    sd = {k: torch.from_numpy((0.2 * rng.standard_normal(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items()}
    torch.save(sd, root / "head.pth")
    for s, slide in enumerate(("slideA", "slideB")):
        d = root / "tiles" / slide
        d.mkdir(parents=True)
        for t in range(6):
            arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"tile_({t}-{s}).jpg", quality=90)
    return root


def _infer_args(root, out):
    return ["--tiles_root", str(root / "tiles"), "--backbone_ckpt", str(root / "backbone.pth"),
            "--head_ckpt", str(root / "head.pth"), "--quantize", "int8", "--out_features", "32",
            "--chunk", "4", "--tile_size", "64", "--topk", "6", "--out_dir", str(out)]


def test_infer_matches_the_jax_cli(checkpoints, capsys):
    from transmil_deepgraft_tpu.cli.infer import main as jax_infer

    root = checkpoints
    got = infer.main(_infer_args(root, root / "port_out") + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["slides"] == 2
    want = jax_infer(_infer_args(root, root / "jax_out"))
    assert [r["slide"] for r in got] == [r["slide"] for r in want] == ["slideA", "slideB"]
    for mine, theirs in zip(got, want):
        assert mine["n_tiles"] == 6 and mine["pred"] == theirs["pred"]
        np.testing.assert_allclose(mine["probs"], theirs["probs"], atol=TOL, rtol=0)
        ours, jaxs = ([row for row in csv.reader(open(r["topk_csv"]))][1:] for r in (mine, theirs))
        assert len(ours) == len(jaxs) == 6  # --topk 6: every tile is ranked
        scores = [float(row[3]) for row in jaxs]
        for i, (a, b) in enumerate(zip(ours, jaxs)):
            if all(abs(scores[i] - s) > 1e-4 for j, s in enumerate(scores) if j != i):
                assert a[:3] == b[:3]  # the same tile and coords at a separated rank
            assert abs(float(a[3]) - float(b[3])) <= 1e-4
    assert json.loads((root / "port_out" / "predictions.json").read_text()) == got


def test_infer_refuses_what_the_port_lacks(checkpoints, monkeypatch):
    """A classic network is no bag head: refused as JAX's create_model
    refuses it (ROADMAP C13). ``--n_chips`` beyond the cards is refused as
    JAX's CLI refuses more chips than devices, and under a launcher its
    world must be ``--n_chips`` (tests/test_torch_parallel.py runs it)."""
    args = _infer_args(checkpoints, checkpoints / "x")
    with pytest.raises(SystemExit, match="unknown model, not a bag head"):
        infer.main(args + ["--model", "vit", "--device", "cpu"])
    with pytest.raises(SystemExit, match="available devices"):
        infer.main(args + ["--n_chips", "64", "--device", "cuda"])
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="WORLD_SIZE 3"):
        infer.main(args + ["--n_chips", "2", "--device", "cpu"])


def test_export_model_bundles_load_and_serve(checkpoints, tmp_path):
    """A head bundle and an int8 slide bundle from .pth checkpoints; the
    daemon serves the slide bundle's /predict_slide with and without
    attention's top-k, as the bundle computes in-process."""
    root = checkpoints
    export_model.main(["--model", "TransMIL", "--ckpt", str(root / "head.pth"), "--out",
                       str(tmp_path / "head.tdx"), "--buckets", "16,32"])
    head = ServingBundle.load(tmp_path / "head.tdx", device="cpu")
    assert head.meta["buckets"] == [16, 32] and head.meta["n_classes"] == 2
    calib = np.random.default_rng(2).standard_normal((4, 64, 64, 3)).astype(np.float32)
    np.save(tmp_path / "calib.npy", calib)
    meta = export_model.main([
        "--model", "TransMIL", "--ckpt", str(root / "head.pth"), "--out",
        str(tmp_path / "slide.tdx"), "--backbone_ckpt", str(root / "backbone.pth"),
        "--calib_tiles", str(tmp_path / "calib.npy"), "--chunk", "4", "--tile_hw", "64",
        "--buckets", "16", "--device", "cpu"])
    assert meta["kind"] == "slide" and meta["backbone"] == "int8"
    slide = ServingBundle.load(tmp_path / "slide.tdx", device="cpu")
    tiles = np.random.default_rng(4).integers(0, 256, (6, 64, 64, 3), np.uint8)
    want_probs, want_scores = slide.predict_slide_with_attention(tiles)
    warmup(slide)
    srv = _serve(slide)
    try:
        port = srv.server_address[1]
        status, doc, _ = _request(port, "POST", "/predict_slide", _npy(tiles),
                                  "application/octet-stream")
        assert status == 200 and doc["pred"] == int(np.argmax(want_probs))
        np.testing.assert_allclose(doc["probs"], want_probs, atol=1e-6)
        assert doc["topk_tiles"] == np.argsort(want_scores)[::-1][:6].tolist()
        slide.meta["attention"] = False
        status, doc, _ = _request(port, "POST", "/predict_slide", _npy(tiles),
                                  "application/octet-stream")
        assert status == 200 and "topk_tiles" not in doc
        np.testing.assert_allclose(doc["probs"], slide.predict_slide(tiles), atol=1e-6)
        status, doc, _ = _request(port, "POST", "/predict_slide", json.dumps({"tiles": [1.0]}))
        assert status == 400 and "error" in doc
    finally:
        _stop(srv)
    with pytest.raises(SystemExit, match="weights, not programs"):
        export_model.main(["--model", "TransMIL", "--ckpt", str(root / "head.pth"), "--out",
                           str(tmp_path / "x.tdx"), "--platforms", "cpu"])
