"""Serving daemon: HTTP inference over a ``.tdx`` bundle (port of
``cli/serve.py``).

``python -m transmil_deepgraft_tpu_torch.cli.serve --bundle head.tdx --port 8000``

Serves a bundle of either package (the port's or one the JAX package
exported) on the card, or on the CPU with ``--device cpu``. Stdlib HTTP
(``http.server``), threaded.

Endpoints:

- ``GET /health``  -> ``{"status": "ok", "model": ..., "buckets": [...]}``
- ``GET /meta``    -> the full bundle metadata
- ``GET /metrics`` -> request counters and a latency histogram (Prometheus text)
- ``POST /predict`` -> logits/probs/pred for one or more feature bags.
  Body is either JSON ``{"features": [[...], ...]}`` (one bag, n x D) /
  ``{"bags": [[[...]]]}`` (batch), or a raw ``.npy`` array (n, D) or
  (B, n, D), or an ``.npz`` with ``features`` (and ``coords``), with
  ``Content-Type: application/octet-stream``. ``coords`` (the tiles' (n, 2)
  or (B, n, 2) grid positions, a JSON key or the ``.npz``'s) go to a
  coord-aware bundle (RoFormerMIL); another bundle answers 400.
- ``POST /predict_slide`` (slide bundles) -> the same for (N, H, W, 3) raw
  uint8 or normalized float32 tiles, with the top-k tiles by attention when
  the bundle has attention.

Concurrency: /predict goes through ``serving.MicroBatcher``: handler threads
validate their own bags and one dispatcher thread runs the device, coalescing
same-bucket bags into one forward. One device lock serializes the dispatcher
and the slide requests. A full queue sheds with 503 + ``Retry-After``.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="serve a .tdx bundle over HTTP")
    p.add_argument("--bundle", required=True, help="path to the exported .tdx bundle")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once before accepting requests")
    p.add_argument("--max_queue", type=int, default=128,
                   help="pending-request bound: beyond it /predict sheds with "
                        "503 + Retry-After instead of growing latency")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; 'cpu' runs the plain versions)")
    return p


def warmup(bundle) -> None:
    """Run every bucket once before accepting requests, at the bundle's batch
    (with attention too where the bundle has it), and a slide bundle's
    backbone on one float32 and one uint8 tile. The port compiles nothing,
    but the first calls build the kernels and prepare the int8 blocks."""
    d = int(bundle.meta["in_features"])
    eb = int(bundle.meta.get("batch", 1))
    for b in bundle.meta["buckets"]:
        bundle.predict_logits(np.zeros((eb, b, d), np.float32))
        if bundle.meta.get("attention"):
            bundle.predict_logits_with_attention(np.zeros((eb, b, d), np.float32))
    if bundle.meta.get("kind") == "slide":
        hw = int(bundle.meta["tile_hw"])
        for dt in (np.float32, np.uint8):
            bundle.embed_tiles(np.zeros((1, hw, hw, 3), dt))


def _predict(batcher, feats: np.ndarray, coords=None) -> dict:
    """A /predict request through the MicroBatcher: validation on this
    handler thread, the forward on the dispatcher's."""
    feats = np.asarray(feats, np.float32)
    if feats.ndim == 2:
        feats = feats[None]
    if feats.ndim != 3:
        raise ValueError(f"features must be (n, D) or (B, n, D), got {feats.shape}")
    if coords is not None:
        coords = np.asarray(coords, np.float32)
        if coords.ndim == 2:
            coords = coords[None]
        if coords.shape[:2] != feats.shape[:2] or coords.shape[-1] != 2:
            raise ValueError(
                f"coords must be {feats.shape[:2] + (2,)}, got {coords.shape}"
            )
    logits = batcher.predict_logits(feats, coords)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    return {
        "logits": logits.tolist(),
        "probs": probs.tolist(),
        "pred": np.argmax(logits, axis=-1).tolist(),
    }


class _Metrics:
    """Request counters + latency histogram, exposed in Prometheus text
    format at ``GET /metrics``."""

    BUCKETS = (0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests: dict[tuple[str, int], int] = {}
        self.hist: dict[str, list[int]] = {}  # endpoint -> per-bucket counts + inf
        self.sum_s: dict[str, float] = {}
        self.started = time.time()

    def observe(self, endpoint: str, status: int, seconds: float) -> None:
        with self._lock:
            key = (endpoint, status)
            self.requests[key] = self.requests.get(key, 0) + 1
            h = self.hist.setdefault(endpoint, [0] * (len(self.BUCKETS) + 1))
            for i, b in enumerate(self.BUCKETS):
                if seconds <= b:
                    h[i] += 1
                    break
            else:
                h[-1] += 1
            self.sum_s[endpoint] = self.sum_s.get(endpoint, 0.0) + seconds

    def render(self) -> str:
        with self._lock:
            lines = ["# TYPE transmil_requests_total counter"]
            for (ep, status), n in sorted(self.requests.items()):
                lines.append(
                    f'transmil_requests_total{{endpoint="{ep}",status="{status}"}} {n}'
                )
            lines.append("# TYPE transmil_request_seconds histogram")
            for ep, h in sorted(self.hist.items()):
                cum = 0
                for b, n in zip(self.BUCKETS, h):
                    cum += n
                    lines.append(
                        f'transmil_request_seconds_bucket{{endpoint="{ep}",le="{b}"}} {cum}'
                    )
                cum += h[-1]
                lines.append(
                    f'transmil_request_seconds_bucket{{endpoint="{ep}",le="+Inf"}} {cum}'
                )
                lines.append(
                    f'transmil_request_seconds_sum{{endpoint="{ep}"}} {self.sum_s[ep]:.6f}'
                )
                lines.append(f'transmil_request_seconds_count{{endpoint="{ep}"}} {cum}')
            lines.append("# TYPE transmil_uptime_seconds gauge")
            lines.append(f"transmil_uptime_seconds {time.time() - self.started:.1f}")
            return "\n".join(lines) + "\n"


def make_server(bundle, host: str, port: int,
                max_queue: int = 128) -> ThreadingHTTPServer:
    from transmil_deepgraft_tpu_torch.serving import MicroBatcher, QueueFullError

    # one device lock shared by the micro-batch dispatcher and the slide /
    # attention paths: the device runs one request at a time, while host-side
    # decoding and validation run concurrently on handler threads
    lock = threading.Lock()
    batcher = MicroBatcher(bundle, device_lock=lock, max_queue=max_queue)
    metrics = _Metrics()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict, headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/health":
                depth = batcher.queue_depth
                self._send(200, {
                    "status": "overloaded" if depth >= batcher.max_queue else "ok",
                    "model": bundle.meta.get("model_name"),
                    "mode": bundle.meta.get("mode"),
                    "buckets": bundle.meta.get("buckets"),
                    "queue_depth": depth,
                    "max_queue": batcher.max_queue,
                })
            elif self.path == "/meta":
                self._send(200, bundle.meta)
            elif self.path == "/metrics":
                body = metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/predict", "/predict_slide"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            t0 = time.perf_counter()
            status = 200
            try:
                # the body is read inside the guard: a malformed
                # Content-Length or a mid-body disconnect is a counted 400
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "application/json")
                coords = None
                if ctype.startswith("application/octet-stream"):
                    loaded = np.load(io.BytesIO(raw), allow_pickle=False)
                    if hasattr(loaded, "files"):  # .npz: features (+ coords)
                        arr = loaded["features"]
                        coords = loaded["coords"] if "coords" in loaded.files else None
                    else:
                        arr = loaded
                else:
                    doc = json.loads(raw)
                    arr = np.asarray(doc.get("features", doc.get("tiles", doc.get("bags"))))
                    coords = np.asarray(doc["coords"]) if "coords" in doc else None
                with torch.inference_mode():  # thread-local: entered on each handler thread
                    if self.path == "/predict_slide":
                        self._send(200, self._slide(arr, coords))
                    else:
                        self._send(200, _predict(batcher, arr, coords))
            except QueueFullError as e:
                # back-pressure: bounded latency beats unbounded queueing
                status = 503
                self._send(503, {
                    "error": str(e),
                    "queue_depth": e.depth,
                    "retry_after_s": e.retry_after_s,
                }, headers={"Retry-After": str(int(e.retry_after_s + 0.999))})
            except Exception as e:  # noqa: BLE001 - surface as HTTP 400
                status = 400
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            finally:
                metrics.observe(self.path, status, time.perf_counter() - t0)

        def _slide(self, arr, coords) -> dict:
            """(N, H, W, 3) raw uint8 or normalized float32 tiles -> slide
            probabilities (and the top-k tiles when the bundle has attention)."""
            if bundle.meta.get("attention"):
                with lock:
                    logits, scores = bundle.predict_slide_logits_with_attention(arr, coords)
                k = min(20, scores.shape[0])
                top = np.argsort(scores)[::-1][:k]
                extra = {"topk_tiles": top.tolist(), "topk_scores": scores[top].tolist()}
            else:
                with lock:
                    logits = bundle.predict_slide_logits(arr, coords)
                extra = {}
            e = np.exp(logits - logits.max())
            return {"logits": logits.tolist(), "probs": (e / e.sum()).tolist(),
                    "pred": int(np.argmax(logits)), **extra}

    class Server(ThreadingHTTPServer):
        # shedding is an application policy (503 + Retry-After): connects must
        # reach a handler thread to be answered, so the listen backlog is
        # larger than socketserver's 5, which a burst of connects overflows
        request_queue_size = 128
        daemon_threads = True

        def server_close(self) -> None:
            super().server_close()
            batcher.close()

    return Server((host, port), Handler)


def main(argv: list[str] | None = None) -> dict:
    from transmil_deepgraft_tpu_torch.serving import ServingBundle

    args = make_parser().parse_args(argv)
    bundle = ServingBundle.load(args.bundle, device=args.device)
    if args.warmup:
        warmup(bundle)
    srv = make_server(bundle, args.host, args.port, max_queue=args.max_queue)
    meta = {"model": bundle.meta.get("model_name"), "host": args.host,
            "port": srv.server_address[1], "device": str(bundle.device)}
    print(json.dumps({**meta, "status": "serving"}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return meta


if __name__ == "__main__":
    main()
