"""The port's serving bundle and MicroBatcher (CPU, small head)."""

import threading
import zipfile

import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.serving import ServingBundle as JaxServingBundle
from transmil_deepgraft_tpu.utils.torch_weights import convert_transmil_state_dict
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.serving import (
    MicroBatcher, QueueFullError, ServingBundle, export_serving_bundle)

IN_FEATURES, N_CLASSES, BUCKETS = 384, 3, (64, 128, 256)


@pytest.fixture(scope="module")
def params():
    """Flax-layout params of a seeded port model (non-zero LN biases)."""
    rng = np.random.default_rng(0)
    model = create_model("TransMIL", N_CLASSES, IN_FEATURES, device="cpu")
    sd = {k: torch.from_numpy((0.2 * rng.standard_normal(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items()}
    return convert_transmil_state_dict(sd, in_features=IN_FEATURES)["params"]


def _export(params, path, batch=1):
    return export_serving_bundle(params, path, model_name="TransMIL", in_features=IN_FEATURES,
                                 n_classes=N_CLASSES, batch=batch, buckets=BUCKETS)


@pytest.fixture(scope="module")
def bundle(params, tmp_path_factory):
    path = tmp_path_factory.mktemp("bundle") / "head.tdx"
    _export(params, path)
    return ServingBundle.load(path, device="cpu")


def _bag(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, IN_FEATURES)).astype(np.float32)


def test_bundle_file_layout(params, tmp_path):
    meta = _export(params, tmp_path / "b.tdx")
    with zipfile.ZipFile(tmp_path / "b.tdx") as z:
        assert sorted(z.namelist()) == ["meta.json", "params.npz"]
    assert meta["buckets"] == list(BUCKETS) and meta["mode"] == "bucketed"
    assert meta["model_name"] == "TransMIL" and meta["n_classes"] == N_CLASSES


def test_bundle_predicts_the_padded_bag(bundle):
    bag = _bag(100)
    logits = bundle.predict_logits(bag)
    padded = np.concatenate([bag, np.zeros((28, IN_FEATURES), np.float32)])
    with torch.no_grad():
        want = bundle.model(torch.from_numpy(padded)).numpy()
    np.testing.assert_array_equal(logits, want)
    probs = bundle.predict(bag)
    assert probs.shape == (1, N_CLASSES)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n", [1, 64, 65, 200])
def test_bucket_padding_matches_jax_bundle(bundle, n):
    """The bag the model sees is the one the JAX bundle's _prepare_one pads
    on the host: same bucket, zero rows after the real ones."""
    jax_bundle = JaxServingBundle(dict(bundle.meta, coord_aware=False), {}, {})
    bag = _bag(n, seed=n)
    got_n, got_target, feats = bundle._prepare_one(bag)
    want_n, want_target, want, _ = jax_bundle._prepare_one(bag, None)
    assert (got_n, got_target) == (want_n, want_target)
    padded = bundle._device_bags([feats], got_target, 1)
    np.testing.assert_array_equal(padded[0].numpy(), want)


def test_bundle_rejects_bad_bags(bundle):
    with pytest.raises(ValueError):
        bundle.predict_logits(_bag(257))  # beyond the largest bucket
    with pytest.raises(ValueError):
        bundle.predict_logits(np.zeros((10, 7), np.float32))
    with pytest.raises(ValueError):
        bundle.predict_logits(np.zeros((2, 10, IN_FEATURES), np.float32))  # batch 1 bundle


def test_predict_logits_with_attention(bundle):
    bag = _bag(90, seed=3)
    logits, scores = bundle.predict_logits_with_attention(bag)
    assert scores.shape == (1, 90) and np.isfinite(scores).all()
    np.testing.assert_allclose(logits, bundle.predict_logits(bag), atol=1e-5)


def test_export_rejects_other_heads(params, tmp_path):
    with pytest.raises(ValueError):
        export_serving_bundle(params, tmp_path / "x.tdx", model_name="AttMIL",
                              in_features=IN_FEATURES, n_classes=N_CLASSES)


def _submit(batcher, bag, results, key):
    def run():
        try:
            results[key] = batcher.predict_logits(bag)
        except Exception as e:  # noqa: BLE001 - recorded for the test to assert on
            results[key] = e
    t = threading.Thread(target=run)
    t.start()
    return t


def _wait_depth(batcher, depth):
    for _ in range(500):
        if batcher.queue_depth == depth:
            return
        threading.Event().wait(0.01)
    raise AssertionError(f"queue depth stayed at {batcher.queue_depth}, expected {depth}")


def test_microbatcher_sheds_at_the_bound(bundle):
    lock = threading.Lock()
    batcher = MicroBatcher(bundle, device_lock=lock, max_queue=2)
    results = {}
    try:
        with lock:  # the device is busy: admitted requests stay pending
            threads = [_submit(batcher, _bag(50, seed=i), results, i) for i in range(2)]
            _wait_depth(batcher, 2)
            with pytest.raises(QueueFullError) as info:
                batcher.predict_logits(_bag(50))
            assert info.value.depth == 2 and info.value.max_queue == 2
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        batcher.close()
    for i in range(2):
        np.testing.assert_allclose(results[i], bundle.predict_logits(_bag(50, seed=i)), atol=1e-5)
    assert batcher.queue_depth == 0


def test_microbatcher_coalesces_same_bucket(params, tmp_path):
    _export(params, tmp_path / "b2.tdx", batch=2)
    bundle2 = ServingBundle.load(tmp_path / "b2.tdx", device="cpu")
    dispatched = []
    forward = bundle2._logits

    def recording(bags, target, batch):
        out = forward(bags, target, batch)
        dispatched.append((bags, target, batch, out))
        return out

    bundle2._logits = recording
    lock = threading.Lock()
    batcher = MicroBatcher(bundle2, device_lock=lock, max_wait_ms=200)
    results = {}
    try:
        with lock:
            threads = [_submit(batcher, _bag(n, seed=n), results, n) for n in (40, 50, 200)]
            _wait_depth(batcher, 3)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        batcher.close()
    # the two 64-bucket bags share one forward, the 256-bucket bag has its own
    # (its batch filled with a zero bag)
    assert sorted((len(bags), target, batch) for bags, target, batch, _ in dispatched) == [
        (1, 256, 2), (2, 64, 2)]
    for n in (40, 50, 200):
        (row,) = [out[i] for bags, _, _, out in dispatched for i, bag in enumerate(bags)
                  if np.array_equal(bag, _bag(n, seed=n))]
        np.testing.assert_array_equal(results[n][0], row)  # each caller gets its own row


def test_microbatcher_close_fails_requests_behind_it(bundle):
    """The bag in dispatch is answered; bags queued behind close() get an
    error instead of blocking their callers forever."""
    lock = threading.Lock()
    batcher = MicroBatcher(bundle, device_lock=lock)
    results = {}
    with lock:
        threads = [_submit(batcher, _bag(30, seed=0), results, 0)]
        _wait_depth(batcher, 1)
        for _ in range(500):  # the dispatcher holds bag 0 and waits for the device
            if batcher._q.qsize() == 0:
                break
            threading.Event().wait(0.01)
        batcher._q.put(batcher._CLOSE)
        threads += [_submit(batcher, _bag(30, seed=i), results, i) for i in (1, 2)]
        _wait_depth(batcher, 3)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    batcher._thread.join(timeout=30)
    assert not batcher._thread.is_alive()
    assert isinstance(results[0], np.ndarray)
    assert isinstance(results[1], RuntimeError) and isinstance(results[2], RuntimeError)
    assert batcher.queue_depth == 0


def _jax_bundle(tmp_path, params):
    """A TransMIL head exported by the JAX package (one bucket, CPU only)."""
    from transmil_deepgraft_tpu.models import create_model as jax_create_model
    from transmil_deepgraft_tpu.serving import export_serving_bundle as jax_export

    model = jax_create_model("TransMIL", N_CLASSES, IN_FEATURES)
    path = tmp_path / "jax_head.tdx"
    meta = jax_export(model, {"params": params}, path, model_name="TransMIL",
                      in_features=IN_FEATURES, buckets=(BUCKETS[1],), platforms=("cpu",),
                      attention=False)
    return path, meta


def test_loads_a_bundle_the_jax_package_exported(params, tmp_path):
    """A bundle written by the JAX package's export_serving_bundle
    (variables.msgpack, no n_classes in its meta) serves from the port with
    the JAX bundle's logits."""
    path, meta = _jax_bundle(tmp_path, params)
    assert "n_classes" not in meta
    bundle = ServingBundle.load(path, device="cpu")
    assert bundle.meta["n_classes"] == N_CLASSES
    bag = _bag(100, seed=7)
    want = JaxServingBundle.load(path).predict_logits(bag)
    got = bundle.predict_logits(bag)
    assert got.shape == want.shape == (1, N_CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_flax_msgpack_reader_refuses_what_it_does_not_know():
    """Everything flax writes for a params tree decodes to numpy; an unknown
    ExtType, bfloat16 arrays and stray bytes raise ValueError."""
    import jax.numpy as jnp
    from flax import serialization

    from transmil_deepgraft_tpu_torch.utils.flax_msgpack import read_flax_msgpack

    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3), "s": np.int64(-3)},
            "b": [1, -200, 70000, 2.5, None, True, "x" * 40, b"\x00\x01"],
            "c": np.zeros((2, 0), np.int8)}
    got = read_flax_msgpack(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"]["k"], tree["a"]["k"])
    assert got["a"]["k"].dtype == np.float32 and got["a"]["s"] == -3
    assert got["b"] == tree["b"] and got["c"].shape == (2, 0)

    unknown_ext = b"\x81\xa1a\xd4\x07\x00"  # {"a": fixext1 of type 7}
    with pytest.raises(ValueError, match="ExtType 7"):
        read_flax_msgpack(unknown_ext)
    with pytest.raises(ValueError, match="bfloat16"):
        read_flax_msgpack(serialization.msgpack_serialize({"w": jnp.ones((2,), jnp.bfloat16)}))
    with pytest.raises(ValueError, match="trailing"):
        read_flax_msgpack(serialization.msgpack_serialize({"w": 1}) + b"\x00")
