"""Feature bags from disk, the data module's file source and the native bag
store of the port against the JAX package's, on the CPU.

A tiny cohort (32-d bags of 20-120 tiles as .npy, .h5 and .pt files) with a
label JSON whose paths carry ``FEATURES_RETCCL_2048``, a patient map, one
slide whose file is missing and one slide absent from the map. Datasets,
train batches (epochs 0-2) and eval batches must be byte-identical to the
JAX package's, on the per-file path and on the bag-store path; a store
written by either package reads back the same in the other.
"""

import json

import numpy as np
import pytest
import torch

from transmil_deepgraft_tpu.data import bagstore as jbagstore
from transmil_deepgraft_tpu.data.datamodule import MILDataModule as JaxDataModule
from transmil_deepgraft_tpu.data.feature_bags import FeatureBagDataset as JaxFeatureBags
from transmil_deepgraft_tpu_torch.data import bagstore as tbagstore
from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
from transmil_deepgraft_tpu_torch.data.feature_bags import FeatureBagDataset

DIM = 32
EXTRACTOR = f"FEATURES_RETCCL_{DIM}"
SPLITS = {"train": 8, "val": 5, "test": 5, "test_mixin": 2}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("cohort")
    bags = root / "data" / EXTRACTOR
    bags.mkdir(parents=True)
    r = np.random.default_rng(0)
    labels, patients = {}, {}
    for split, n in SPLITS.items():
        labels[split] = []
        for i in range(n):
            name, y = f"{split}_{i}", i % 2
            x = (r.standard_normal((int(r.integers(20, 121)), DIM)) + 0.5 * y).astype(np.float32)
            kind = i % 3
            if kind == 0:
                np.save(bags / f"{name}.npy", x)
                rel = f"FEATURES_RETCCL_2048/{name}.npy"
            elif kind == 1:  # extension-less entry, resolved to .h5
                with h5py.File(bags / f"{name}.h5", "w") as f:
                    f["features"] = x
                    f["coords"] = r.integers(0, 60, (len(x), 2)).astype(np.int32)
                rel = f"FEATURES_RETCCL_2048/{name}"
            else:
                torch.save(torch.from_numpy(x), bags / f"{name}.pt")
                rel = f"FEATURES_RETCCL_2048/{name}.pt"
            labels[split].append([rel, y])
            patients[name] = f"{split}_p{i // 4}_{y}"  # two slides of one label a patient
    labels["train"].append(["FEATURES_RETCCL_2048/train_missing.npy", 1])  # no file
    patients["train_missing"] = "train_pm"
    del patients["val_3"]  # absent from the map: skipped
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps(patients))
    return root


def _kwargs(cohort, **over):
    kw = dict(slide_patient_path=str(cohort / "patients.json"), max_bag_size=48,
              feature_extractor=EXTRACTOR)
    kw.update(over)
    return kw


def _same_item(a, b):
    assert a[0].dtype == b[0].dtype and a[0].tobytes() == b[0].tobytes()
    assert a[1] == b[1] and a[2][0] == b[2][0] and a[2][2] == b[2][2]
    assert np.asarray(a[2][1]).tobytes() == np.asarray(b[2][1]).tobytes()


@pytest.mark.parametrize("mode, mixup", [("train", False), ("train", True), ("val", False),
                                         ("test", False), ("fine_tune", False),
                                         ("fine_tune", True)])
def test_feature_bag_items_match_jax(cohort, mode, mixup):
    args = (str(cohort / "data"), str(cohort / "labels.json"), mode, 2)
    jds = JaxFeatureBags(*args, **_kwargs(cohort, mixup=mixup))
    tds = FeatureBagDataset(*args, **_kwargs(cohort, mixup=mixup))
    assert (tds.names, tds.patients, tds.labels, tds.missing) == \
        (jds.names, jds.patients, jds.labels, jds.missing)
    assert [p.name for p in tds.files] == [p.name for p in jds.files]
    assert len(tds) == {"train": 8, "val": 4, "test": 5, "fine_tune": 10}[mode]
    if mode == "train":
        assert tds.missing == [f"{EXTRACTOR}/train_missing.npy"]
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(len(tds)):
        _same_item(jds.get_item(i, jrng), tds.get_item(i, trng))


def _batches(dm, epochs=(0, 1, 2)):
    out = [b for e in epochs for b in dm.train_batches(e)]
    return out + [b for m in ("val", "test") for b in dm.eval_batches(m, batch_size=2)]


@pytest.mark.parametrize("store", [False, True], ids=["files", "bagstore"])
@pytest.mark.parametrize("mixup", [False, True], ids=["plain", "mixup"])
def test_datamodule_batches_match_jax(cohort, tmp_path, store, mixup):
    kw = dict(n_classes=2, max_bag_size=48, batch_size=3, mixup=mixup, seed=5,
              feature_extractor=EXTRACTOR, slide_patient_path=str(cohort / "patients.json"))
    jdm = JaxDataModule(str(cohort / "data"), str(cohort / "labels.json"), **kw)
    tdm = MILDataModule(str(cohort / "data"), str(cohort / "labels.json"), **kw)
    if store:
        jdm.enable_bagstore(str(tmp_path / "jax.bags"), n_threads=2)
        tdm.enable_bagstore(str(tmp_path / "port.bags"), n_threads=2)
        assert (tmp_path / "port.bags").read_bytes() == (tmp_path / "jax.bags").read_bytes()
    jbs, tbs = _batches(jdm), _batches(tdm)
    assert len(jbs) == len(tbs) == 3 * 2 + 2 + 3
    for jb, tb in zip(jbs, tbs):
        assert jb.bags.shape == tb.bags.shape and jb.bags.tobytes() == tb.bags.tobytes()
        np.testing.assert_array_equal(jb.labels, tb.labels)
        np.testing.assert_array_equal(jb.lengths, tb.lengths)
        assert (jb.names, jb.patients) == (tb.names, tb.patients)
        assert (jb.padded_coords is None) == (tb.padded_coords is None)
        if jb.padded_coords is not None:
            assert jb.padded_coords.tobytes() == tb.padded_coords.tobytes()
    assert jdm.steps_per_epoch() == tdm.steps_per_epoch() == 2


def test_bagstore_reads_across_packages(tmp_path):
    r = np.random.default_rng(1)
    bags = [r.standard_normal((n, DIM)).astype(np.float32) for n in (7, 64, 130)]
    coords = [r.integers(0, 99, (len(b), 2)).astype(np.int32) for b in bags]
    tbagstore.write_bagstore(tmp_path / "port.bags", bags, coords)
    jbagstore.write_bagstore(tmp_path / "jax.bags", bags, coords)
    for path in ("port.bags", "jax.bags"):
        stores = (tbagstore.BagStore(tmp_path / path), jbagstore.BagStore(tmp_path / path))
        for s in stores:
            assert (s.n_slides, s.dim) == (3, DIM)
            for i, (b, c) in enumerate(zip(bags, coords)):
                assert s.read_bag(i).tobytes() == b.tobytes()
                assert s.read_coords(i).tobytes() == c.tobytes()
        for slide in range(3):
            for k, pad in ((16, True), (100, True), (100, False)):
                got, want = stores[0].sample_bag(slide, k, 11, pad), stores[1].sample_bag(
                    slide, k, 11, pad)
                assert got[1] == want[1] and got[0][:got[1]].tobytes() == want[0][:want[1]].tobytes()
        got = stores[0].assemble_batch([2, 0, 1, 2], k=50, seed=3, n_threads=2)
        assert got.tobytes() == stores[1].assemble_batch([2, 0, 1, 2], k=50, seed=3,
                                                         n_threads=2).tobytes()
        for s in stores:
            s.close()
    with pytest.raises(IndexError):
        tbagstore.BagStore(tmp_path / "port.bags").read_bag(3)


@pytest.mark.parametrize("over", [{"variant": "spatial"}, {"variant": "images"},
                                  {"variant": "tiles"}, {"variant": "image_bags"},
                                  {"dataset_name": "camelyon"}], ids=str)
def test_datamodule_refuses_what_is_not_ported(cohort, over):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        MILDataModule(str(cohort / "data"), str(cohort / "labels.json"), **over)
