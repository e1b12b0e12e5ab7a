"""Serving bundles and cross-request micro-batching (port of ``serving.py``).

A bundle is one zip file holding ``meta.json`` and ``params.npz``, the
flax-layout parameters flattened to ``"a/b/c"`` keys (:mod:`utils.jax_params`),
so one set of trained weights serves from either package. :meth:`ServingBundle.load`
also reads the bundles the JAX package exports (``variables.msgpack``, read by
:mod:`utils.flax_msgpack`): it rebuilds the head from the weights and never
reads their ``exported/*.jexp`` programs.

    export_serving_bundle(params, "head.tdx", model_name="TransMIL",
                          in_features=2048, n_classes=2)
    bundle = ServingBundle.load("head.tdx")          # on the card
    probs = bundle.predict(features)                 # (n, D) -> (1, C)

Bags are zero-padded to the next bucket length, as the JAX bundles' bucketed
mode (and the trainer's ``eval_pad='bucket'`` policy) do, so each bucket is
one shape. The pad is made on the device: only the real rows cross from the
host (padding a 40,960-tile bag to 65,536 rows in numpy cost more than the
forward). This slice serves feature bags for the TransMIL head; coords,
coord-aware heads and slide bundles are not ported yet.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.utils.flax_msgpack import read_flax_msgpack
from transmil_deepgraft_tpu_torch.utils.jax_params import flatten, state_dict_from_jax, unflatten

FORMAT_VERSION = 1
# Serving buckets default to the mid-range of ops.padding.DEFAULT_BUCKETS.
DEFAULT_SERVING_BUCKETS: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)


def export_serving_bundle(
    params: Mapping[str, Any],
    path: str | Path,
    *,
    model_name: str,
    in_features: int,
    n_classes: int,
    batch: int = 1,
    buckets: Sequence[int] = DEFAULT_SERVING_BUCKETS,
) -> dict:
    """Write a ``.tdx`` bundle from flax-layout ``params``; returns its meta."""
    if model_name != "TransMIL":
        raise ValueError(f"the port serves TransMIL bundles only, not {model_name!r}")
    meta = {
        "format_version": FORMAT_VERSION,
        "model_name": model_name,
        "in_features": int(in_features),
        "n_classes": int(n_classes),
        "batch": int(batch),
        "mode": "bucketed",
        "buckets": sorted(int(b) for b in buckets),
        "attention": True,
        "coord_aware": False,
    }
    buf = io.BytesIO()
    np.savez(buf, **flatten(params))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("params.npz", buf.getvalue())
    return meta


class ServingBundle:
    """A loaded bundle: ``predict(feats)`` on one device. The weights are
    staged on the device once, at load."""

    def __init__(self, meta: dict, params: Mapping[str, Any],
                 device: str | torch.device | None = None) -> None:
        self.meta = meta
        self.model = create_model(meta["model_name"], meta["n_classes"],
                                  meta["in_features"], device=device)
        self.device = next(self.model.parameters()).device
        self.model.load_state_dict(state_dict_from_jax(params, meta["in_features"]))
        self.model.eval()

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device | None = None) -> "ServingBundle":
        """Load a bundle of either package: the port's ``params.npz`` or the
        JAX package's ``variables.msgpack`` (its ``batch_stats``, if any, are
        not used by TransMIL; ``n_classes`` comes from the head's weights when
        the meta has none)."""
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"bundle format {meta['format_version']} is newer than "
                    f"this loader ({FORMAT_VERSION})"
                )
            names = z.namelist()
            if "params.npz" in names:
                with np.load(io.BytesIO(z.read("params.npz"))) as npz:
                    params = unflatten({k: npz[k] for k in npz.files})
            elif "variables.msgpack" in names:
                params = read_flax_msgpack(z.read("variables.msgpack"))["params"]
                meta.setdefault("n_classes", int(np.shape(params["fc"]["kernel"])[1]))
            else:
                raise ValueError(f"{path} holds neither params.npz (a bundle of the port) nor "
                                 "variables.msgpack (a bundle of the JAX package)")
        return cls(meta, params, device)

    def _pad_target(self, n: int) -> int:
        for b in self.meta["buckets"]:
            if n <= b:
                return b
        raise ValueError(
            f"bag of {n} tiles exceeds the largest exported bucket "
            f"({self.meta['buckets'][-1]}); re-export with larger buckets"
        )

    def _prepare_one(self, feats: np.ndarray) -> tuple[int, int, np.ndarray]:
        """The single-bag input contract shared by the batched predict and
        :class:`MicroBatcher`: validate dims and pick the serving bucket.
        Returns ``(n_real, target, (n_real, D) float32 feats)``; the zero pad
        to ``target`` rows is made on the device by :meth:`_device_bags`."""
        feats = np.ascontiguousarray(feats, np.float32)
        if feats.ndim != 2:
            raise ValueError(f"each bag must be (n, D), got {feats.shape}")
        n, d = feats.shape
        if d != self.meta["in_features"]:
            raise ValueError(f"expected in_features={self.meta['in_features']}, got {d}")
        return n, self._pad_target(n), feats

    def _prepare_inputs(self, feats: np.ndarray) -> tuple[int, int, list[np.ndarray]]:
        """Validate a (n, D) or (B, n, D) request; returns (n_real, target,
        B bags)."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[None]
        if feats.ndim != 3:
            raise ValueError(f"features must be (n, D) or (B, n, D), got {feats.shape}")
        if feats.shape[0] != self.meta["batch"]:
            raise ValueError(f"bundle exported for batch={self.meta['batch']}, got {feats.shape[0]}")
        n, target, _ = self._prepare_one(feats[0])
        return n, target, list(feats)

    def _device_bags(self, bags: Sequence[np.ndarray], target: int, batch: int) -> torch.Tensor:
        """(batch, target, D) zeros on the device holding ``bags`` in its
        first rows: the bucket zero pad, with only real rows copied over.
        Rows past ``len(bags)`` stay zero bags."""
        x = torch.zeros((batch, target, self.meta["in_features"]), dtype=torch.float32,
                        device=self.device)
        for i, bag in enumerate(bags):
            x[i, :len(bag)] = torch.from_numpy(bag)
        return x

    def _logits(self, bags: Sequence[np.ndarray], target: int, batch: int) -> np.ndarray:
        """Bags of at most ``target`` rows -> (batch, C) logits."""
        with torch.inference_mode():
            return self.model(self._device_bags(bags, target, batch)).cpu().numpy()

    def predict_logits(self, feats: np.ndarray) -> np.ndarray:
        """(n, D) or (B, n, D) float32 features -> (B, C) logits."""
        _, target, bags = self._prepare_inputs(feats)
        return self._logits(bags, target, len(bags))

    def predict(self, feats: np.ndarray) -> np.ndarray:
        """(n, D) or (B, n, D) features -> (B, C) class probabilities."""
        return _softmax(self.predict_logits(feats))

    def predict_logits_with_attention(self, feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(n, D) or (B, n, D) features -> ((B, C) logits, (B, n) per-tile
        attention scores): heads averaged, padding scores stripped."""
        n, target, bags = self._prepare_inputs(feats)
        with torch.inference_mode():
            logits, attn = self.model(self._device_bags(bags, target, len(bags)),
                                      return_attn=True)
            scores = attn.tile_scores().mean(dim=1)
            return logits.cpu().numpy(), scores[:, :n].cpu().numpy()


def _softmax(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


class QueueFullError(RuntimeError):
    """MicroBatcher admission control: the pending-request queue is at its
    bound; the caller should shed (HTTP 503 + Retry-After) rather than let
    latency grow without limit."""

    def __init__(self, depth: int, max_queue: int, retry_after_s: float) -> None:
        super().__init__(
            f"serving queue full ({depth}/{max_queue} pending); retry in "
            f"~{retry_after_s:.1f}s"
        )
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


class MicroBatcher:
    """Cross-request micro-batching for a :class:`ServingBundle`.

    One dispatcher thread owns the device; request threads validate and
    bucket-pad their own bags, enqueue them and block on a future. The
    dispatcher coalesces up to ``meta['batch']`` queued bags OF THE SAME
    BUCKET into one forward, waiting at most ``max_wait_ms`` for stragglers
    once the first bag is in hand. Bags for other buckets wait for the next
    dispatch. At ``max_queue`` admitted-but-unanswered requests, new ones are
    shed with :class:`QueueFullError`.
    """

    _CLOSE = object()

    def __init__(self, bundle: ServingBundle, max_wait_ms: float = 2.0,
                 device_lock=None, max_queue: int = 128) -> None:
        import queue as _queue
        import threading

        self.bundle = bundle
        self.eb = int(bundle.meta.get("batch", 1))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = int(max_queue)
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._q: "_queue.Queue" = _queue.Queue()
        self._queue_mod = _queue
        # serializes device use with other device users; held per dispatch
        self._device_lock = device_lock or threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet answered (queued + in dispatch)."""
        with self._depth_lock:
            return self._depth

    def _release(self, k: int = 1) -> None:
        with self._depth_lock:
            self._depth -= k

    def predict_logits(self, feats: np.ndarray) -> np.ndarray:
        """(n, D) / (B, n, D) features -> (B, C) logits (B bags enqueue as B
        independent micro-batchable requests)."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[None]
        if feats.ndim != 3:
            raise ValueError(f"features must be (n, D) or (B, n, D), got {feats.shape}")
        futures = [self._enqueue(f) for f in feats]
        return np.stack([f.result() for f in futures])

    def predict(self, feats: np.ndarray) -> np.ndarray:
        return _softmax(self.predict_logits(feats))

    def close(self) -> None:
        self._q.put(self._CLOSE)
        self._thread.join(timeout=5)

    def _enqueue(self, feats: np.ndarray):
        """Admission-check, then validate on the request thread; returns a
        Future."""
        from concurrent.futures import Future

        with self._depth_lock:
            if self._depth >= self.max_queue:
                raise QueueFullError(
                    self._depth, self.max_queue,
                    retry_after_s=max(1.0, self._depth * self.max_wait_s),
                )
            self._depth += 1
        try:
            _, target, feats = self.bundle._prepare_one(feats)
        except BaseException:
            self._release()
            raise
        fut: Future = Future()
        self._q.put((target, feats, fut))
        return fut

    def _run(self) -> None:
        import time as _time
        from collections import deque

        pending: deque = deque()

        def shutdown(final_group=None):
            """Dispatch what is in hand, then fail every undelivered future."""
            if final_group:
                self._dispatch(final_group)
            leftovers = list(pending)
            while True:
                try:
                    it = self._q.get_nowait()
                except self._queue_mod.Empty:
                    break
                if it is not self._CLOSE:
                    leftovers.append(it)
            for it in leftovers:
                fut = it[-1]
                if not fut.done():
                    fut.set_exception(RuntimeError("MicroBatcher closed before dispatch"))
            self._release(len(leftovers))

        while True:
            item = pending.popleft() if pending else self._q.get()
            if item is self._CLOSE:
                shutdown()
                return
            key = item[0]
            group = [item]
            for other in list(pending):  # compatible bags already deferred, oldest first
                if len(group) >= self.eb:
                    break
                if other[0] == key:
                    pending.remove(other)
                    group.append(other)
            deadline = _time.monotonic() + self.max_wait_s
            while len(group) < self.eb:  # then stragglers on the live queue
                timeout = deadline - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except self._queue_mod.Empty:
                    break
                if nxt is self._CLOSE:
                    shutdown(final_group=group)
                    return
                if nxt[0] == key and len(group) < self.eb:
                    group.append(nxt)
                else:
                    pending.append(nxt)
            self._dispatch(group)

    def _dispatch(self, group: list) -> None:
        try:
            with self._device_lock:  # the batch is filled with zero bags
                logits = self.bundle._logits([g[1] for g in group], group[0][0], self.eb)
            for i, (_, _, fut) in enumerate(group):
                fut.set_result(logits[i])
        except Exception as e:  # noqa: BLE001 - deliver to every waiter
            for _, _, fut in group:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self._release(len(group))
