"""Feature bags from disk, the data module's file source and the native bag
store of the port against the JAX package's, on the CPU.

A tiny cohort (32-d bags of 20-120 tiles as .npy, .h5 and .pt files) with a
label JSON whose paths carry ``FEATURES_RETCCL_2048``, a patient map, one
slide whose file is missing and one slide absent from the map. Datasets,
train batches (epochs 0-2) and eval batches must be byte-identical to the
JAX package's, on the per-file path and on the bag-store path; a store
written by either package reads back the same in the other. The data
module's other sources (JPEG tile folders, legacy tile stacks, Camelyon)
give JAX's batches too.
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


@pytest.fixture(scope="module")
def image_cohorts(tmp_path_factory):
    """The other sources of the data module: slides as folders of 16x16 JPEG
    tiles named with their (x-y) grid position (``images``), the same tiles
    as .npy stacks (``image_bags``), and Camelyon's fold CSV (columns of
    uneven length) with .pt feature bags. Returns {source: (data_dir,
    label_path)}."""
    from PIL import Image

    root = tmp_path_factory.mktemp("image_cohorts")
    for sub in ("stacks", "camelyon"):
        (root / sub).mkdir()
    r = np.random.default_rng(1)
    labels, columns = {}, {}
    for split, n in (("train", 5), ("val", 2), ("test", 3)):
        labels[split], columns[split], columns[f"{split}_label"] = [], [], []
        for i in range(n):
            name, y = f"{split}_{i}", i % 2
            tiles = r.integers(0, 256, (int(r.integers(3, 8)), 16, 16, 3), dtype=np.uint8)
            folder = root / "jpg" / "BLOCKS" / name
            folder.mkdir(parents=True)
            for t, img in enumerate(tiles):
                Image.fromarray(img).save(folder / f"{name}_({t + 3}-{t % 2 + 1}).jpg")
            np.save(root / "stacks" / f"{name}.npy", tiles)
            feats = r.standard_normal((int(r.integers(5, 30)), DIM)).astype(np.float32)
            torch.save(torch.from_numpy(feats), root / "camelyon" / f"{name}.pt")
            labels[split].append([name, y])
            columns[split].append(name)
            columns[f"{split}_label"].append(str(y))
    (root / "labels.json").write_text(json.dumps(labels))
    rows = max(len(c) for c in columns.values())
    lines = ["," + ",".join(columns)]
    for i in range(rows):
        lines.append(f"{i}," + ",".join(c[i] if i < len(c) else "" for c in columns.values()))
    (root / "fold0.csv").write_text("\n".join(lines) + "\n")
    return {"images": (root / "jpg", root / "labels.json"),
            "image_bags": (root / "stacks", root / "labels.json"),
            "camelyon": (root / "camelyon", root)}


# the spatial variant on feature bags is held in tests/test_torch_zoo.py; with
# Camelyon's source it reads Camelyon's bags, as in JAX. 'tiles' (the classic
# per-tile models) reads the images variant's folders tile by tile.
@pytest.mark.parametrize("over", [{"variant": "spatial", "dataset_name": "camelyon"},
                                  {"variant": "images"},
                                  {"variant": "tiles"}, {"variant": "image_bags"},
                                  {"dataset_name": "camelyon"}], ids=str)
def test_datamodule_refuses_what_is_not_ported(cohort, image_cohorts, over):
    """Every source, the classic per-tile one included, gives JAX's train
    batches (epochs 0 and 1) and eval batches byte for byte."""
    source = over.get("dataset_name", over.get("variant"))
    data_dir, label_path = image_cohorts["images" if source == "tiles" else source]
    kw = dict(n_classes=2, max_bag_size=5, batch_size=2, tile_size=16, **over)
    jdm = JaxDataModule(str(data_dir), str(label_path), **kw)
    tdm = MILDataModule(str(data_dir), str(label_path), **kw)
    pairs = [(jdm.train_batches(e), tdm.train_batches(e)) for e in (0, 1)]
    pairs += [(jdm.eval_batches(m, batch_size=2), tdm.eval_batches(m, batch_size=2))
              for m in ("val", "test")]
    for jb_iter, tb_iter in pairs:
        jbs, tbs = list(jb_iter), list(tb_iter)
        assert len(jbs) == len(tbs) > 0
        for jb, tb in zip(jbs, tbs):
            assert jb.bags.shape == tb.bags.shape and jb.bags.tobytes() == tb.bags.tobytes()
            assert jb.labels.tobytes() == tb.labels.tobytes()
            assert jb.lengths.tobytes() == tb.lengths.tobytes()
            assert (jb.names, jb.patients) == (tb.names, tb.patients)
            assert [c.tobytes() for c in jb.coords] == [c.tobytes() for c in tb.coords]
            assert (jb.padded_coords is None) == (tb.padded_coords is None)
            if jb.padded_coords is not None:
                assert jb.padded_coords.tobytes() == tb.padded_coords.tobytes()
