"""The port's image data against the JAX package's, on the CPU: the
augmentation stack, JPEG tile-folder bags, legacy image bags, Camelyon's fold
CSVs, whole-slide grid patches, the feature-file tools, the prefetch
pipeline, and the HDF5 files of ``utils/h5`` against h5py both ways.

Every dataset item and transform output must be byte-identical to JAX's on
the same numpy-seeded inputs. (The data module's batches of these sources
are held in ``test_torch_feature_bags.py``.)
"""

import json

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from transmil_deepgraft_tpu.data import camelyon as jcamelyon
from transmil_deepgraft_tpu.data import image_bags as jimage_bags
from transmil_deepgraft_tpu.data import jpg_bags as jjpg
from transmil_deepgraft_tpu.data import pipeline as jpipeline
from transmil_deepgraft_tpu.data import tools as jtools
from transmil_deepgraft_tpu.data import transforms as jtf
from transmil_deepgraft_tpu.data import wsi as jwsi
from transmil_deepgraft_tpu_torch.data import camelyon as tcamelyon
from transmil_deepgraft_tpu_torch.data import image_bags as timage_bags
from transmil_deepgraft_tpu_torch.data import jpg_bags as tjpg
from transmil_deepgraft_tpu_torch.data import pipeline as tpipeline
from transmil_deepgraft_tpu_torch.data import tools as ttools
from transmil_deepgraft_tpu_torch.data import transforms as ttf
from transmil_deepgraft_tpu_torch.data import wsi as twsi
from transmil_deepgraft_tpu_torch.utils import h5

TILE = 32


def _same_item(a, b):
    assert a[0].dtype == b[0].dtype and a[0].shape == b[0].shape
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1] == b[1] and a[2][0] == b[2][0] and a[2][2] == b[2][2]
    assert np.asarray(a[2][1]).tobytes() == np.asarray(b[2][1]).tobytes()


# ------------------------------------------------------------- transforms

TRANSFORMS = {
    "color_jitter": lambda m, img, r: m.color_jitter(img, r),
    "hed_jitter": lambda m, img, r: m.hed_jitter(img, 0.05, r),
    "flip_rotate": lambda m, img, r: m.random_flip_rotate(img, r),
    "gauss_blur": lambda m, img, r: m.random_gauss_blur(img, r, p=1.0),
    "affine": lambda m, img, r: m.random_affine(img, 0.1, r),
    "elastic": lambda m, img, r: m.random_elastic(img, 2.0, 0.06, r),
    "train_augment": lambda m, img, r: m.train_augment(img, r, geometric_p=1.0),
    "imagenet_normalize": lambda m, img, r: m.imagenet_normalize(img),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_match_jax(name):
    """Each transform, from the same Generator seed, gives JAX's array byte
    for byte (three seeds, a non-square tile for the geometric ones)."""
    for seed in range(3):
        img = np.random.default_rng(seed).integers(0, 256, (TILE, TILE + 8, 3), dtype=np.uint8)
        want = TRANSFORMS[name](jtf, img.copy(), np.random.default_rng(seed + 10))
        got = TRANSFORMS[name](ttf, img.copy(), np.random.default_rng(seed + 10))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# -------------------------------------------------------------- jpg bags

@pytest.fixture(scope="module")
def jpg_cohort(tmp_path_factory):
    """3 slides of 2-6 tiles (JPEG and one PNG, (x-y) names) in BLOCKS/, a
    label JSON (one entry without a folder) and a patient map."""
    root = tmp_path_factory.mktemp("jpg")
    r = np.random.default_rng(0)
    labels = {"train": [], "test": [], "test_mixin": []}
    for i, n in enumerate((6, 2, 4)):
        name = f"slide_{i}"
        folder = root / "BLOCKS" / name
        folder.mkdir(parents=True)
        for t in range(n):
            img = Image.fromarray(r.integers(0, 256, (TILE + 4, TILE + 4, 3), dtype=np.uint8))
            img.save(folder / f"{name}_({t + 2}-{3 * t}).{'png' if t == 1 else 'jpg'}")
        for split in ("train", "test"):
            labels[split].append([f"some/where/{name}", i % 2])
    labels["train"].append(["slide_missing", 1])
    labels["test_mixin"].append(["slide_2", 0])
    (root / "labels.json").write_text(json.dumps(labels))
    (root / "patients.json").write_text(json.dumps({"slide_0": "p0", "slide_1": "p0"}))
    return root


@pytest.mark.parametrize("mode", ["train", "test", "fine_tune", "tiles"])
def test_jpg_items_match_jax(jpg_cohort, mode):
    """JPGMILDataset items (train: a 4-tile subsample or a zero pad to 4;
    eval: every tile) and JPGTileDataset items (train_augment) equal JAX's,
    with the same slides, labels and patients."""
    kw = dict(slide_patient_path=jpg_cohort / "patients.json", max_bag_size=4, tile_size=TILE)
    split = "train" if mode == "tiles" else mode
    jds = jjpg.JPGMILDataset(jpg_cohort, jpg_cohort / "labels.json", split, 2, **kw)
    tds = tjpg.JPGMILDataset(jpg_cohort, jpg_cohort / "labels.json", split, 2, **kw)
    assert (jds.names, jds.labels, jds.patients) == (tds.names, tds.labels, tds.patients)
    assert len(tds) == (4 if mode == "fine_tune" else 3)
    if mode == "tiles":
        jds, tds = jjpg.JPGTileDataset(jds), tjpg.JPGTileDataset(tds)
        assert len(tds) == len(jds) == 12 and tds.get_labels() == jds.get_labels()
    for i in range(len(tds)):
        _same_item(jds.get_item(i, np.random.default_rng(i)),
                   tds.get_item(i, np.random.default_rng(i)))


# ------------------------------------------------------------ image bags

@pytest.fixture(scope="module")
def stack_cohort(tmp_path_factory):
    """Tile stacks: per-tile datasets (.hdf5), one 'images' dataset (.h5),
    .npy; a label entry without a file."""
    root = tmp_path_factory.mktemp("stacks")
    r = np.random.default_rng(2)
    entries = []
    for i, n in enumerate((6, 10, 3, 8)):
        name = f"slide_{i}"
        imgs = r.integers(0, 256, (n, TILE, TILE, 3), dtype=np.uint8)
        if i == 0:
            with h5py.File(root / f"{name}.hdf5", "w") as f:
                for t in range(n):
                    f[f"tile_{t:03d}"] = imgs[t]
        elif i == 1:
            with h5py.File(root / f"{name}.h5", "w") as f:
                f["images"] = imgs
        else:
            np.save(root / f"{name}.npy", imgs)
        entries.append([name, i % 2])
    entries.append(["missing_slide", 0])
    (root / "labels.json").write_text(json.dumps({"train": entries, "val": entries[:2]}))
    return root


@pytest.mark.parametrize("mode, augment", [("train", False), ("train", True), ("val", False)])
def test_image_bag_items_match_jax(stack_cohort, mode, augment):
    """load_image_bag on every storage, ImageBagDataset items (the bag draw,
    the slide-consistent augmentation, the black pad, [-1, 1]) and the LRU
    cache equal JAX's."""
    for name in ("slide_0.hdf5", "slide_1.h5", "slide_2.npy"):
        want = jimage_bags.load_image_bag(stack_cohort / name)
        assert timage_bags.load_image_bag(stack_cohort / name).tobytes() == want.tobytes()
    kw = dict(bag_size=8, augment=augment, cache_size=2)
    jds = jimage_bags.ImageBagDataset(stack_cohort, stack_cohort / "labels.json", mode, 2, **kw)
    tds = timage_bags.ImageBagDataset(stack_cohort, stack_cohort / "labels.json", mode, 2, **kw)
    assert tds.missing == jds.missing and tds.names == jds.names
    for i in list(range(len(tds))) * 2:
        _same_item(jds.get_item(i, np.random.default_rng(i)),
                   tds.get_item(i, np.random.default_rng(i)))
    assert list(tds._cache) == list(jds._cache) and len(tds._cache) <= 2
    assert timage_bags.range_normalize(np.array([0, 255], np.uint8)).tolist() == [-1.0, 1.0]
    with pytest.raises(ValueError, match="unsupported"):
        timage_bags.load_image_bag(stack_cohort / "labels.json")


# -------------------------------------------------------------- camelyon

def test_camelyon_matches_jax_and_pandas(tmp_path):
    """The fold CSV (uneven columns: empty and NA cells) parses as
    pandas.read_csv(index_col=0) reads it, and CamelyonDataset items (full
    bags; a max_bag_size subsample and pad in train) equal JAX's."""
    r = np.random.default_rng(3)
    cols = {"train": ["tumor_001", "normal_002", "tumor_003", "normal_004"],
            "train_label": ["1", "0", "1", "0"],
            "val": ["normal_005", "NA"], "val_label": ["0", ""],
            "test": ["tumor_006", "normal_007", "tumor_008"], "test_label": ["1", "0", "1.0"]}
    lines = ["," + ",".join(cols)]
    for i in range(4):
        lines.append(f"{i}," + ",".join(c[i] if i < len(c) else "" for c in cols.values()))
    (tmp_path / "fold1.csv").write_text("\n".join(lines) + "\n")
    for names in (cols["train"], cols["val"][:1], cols["test"]):
        for name in names:
            n = int(r.integers(3, 12))
            torch.save(torch.from_numpy(r.standard_normal((n, 8)).astype(np.float32)),
                       tmp_path / f"{name}.pt")
    df = pd.read_csv(tmp_path / "fold1.csv", index_col=0)
    parsed = tcamelyon.read_fold_columns(tmp_path / "fold1.csv")
    assert list(parsed) == list(df.columns)
    for col in df.columns:
        want = df[col].dropna().tolist()
        if col.endswith("_label"):
            assert [int(float(v)) for v in parsed[col]] == [int(v) for v in want]
        else:
            assert parsed[col] == [str(v) for v in want]
    for mode, bag in (("train", 0), ("train", 6), ("val", 0), ("test", 0), ("fine_tune", 4)):
        jds = jcamelyon.CamelyonDataset(tmp_path, tmp_path, mode, fold=1, max_bag_size=bag)
        tds = tcamelyon.CamelyonDataset(tmp_path, tmp_path, mode, fold=1, max_bag_size=bag)
        assert (tds.names, tds.get_labels()) == (jds.names, jds.get_labels())
        for i in range(len(tds)):
            _same_item(jds.get_item(i, np.random.default_rng(i)),
                       tds.get_item(i, np.random.default_rng(i)))


# ------------------------------------------------------------------- wsi

def test_wsi_grid_patches_match_jax(tmp_path):
    """grid_patches (the tissue filter; a random subset with rng) and
    WSIDataset items on a PIL-readable slide equal JAX's."""
    r = np.random.default_rng(4)
    img = np.full((3 * TILE + 5, 4 * TILE, 3), 235, np.uint8)  # background
    img[:2 * TILE, TILE:3 * TILE] = r.integers(0, 256, (2 * TILE, 2 * TILE, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "slide.png")
    Image.fromarray(np.full((TILE, TILE, 3), 240, np.uint8)).save(tmp_path / "blank.png")
    for kw in ({}, {"stride": TILE // 2}, {"max_patches": 3}, {"max_patches": 3, "rng": 5}):
        kw = dict(kw)
        seed = kw.pop("rng", None)
        args = dict(patch_size=TILE, min_tissue=0.1, **kw)
        want = list(jwsi.grid_patches(jwsi.PILSlideReader(tmp_path / "slide.png"), **args,
                                      rng=None if seed is None else np.random.default_rng(seed)))
        got = list(twsi.grid_patches(twsi.open_slide(tmp_path / "slide.png"), **args,
                                     rng=None if seed is None else np.random.default_rng(seed)))
        assert [xy for _, xy in got] == [xy for _, xy in want] and len(got) > 0
        assert all(g.tobytes() == w.tobytes() for (g, _), (w, _) in zip(got, want))
    (tmp_path / "datalist.json").write_text(json.dumps({"training": [
        {"image": "slide.png", "label": 1}, {"image": "blank.png", "label": 0, "patient": "p"}]}))
    jds = jwsi.WSIDataset(tmp_path / "datalist.json", patch_size=TILE, max_patches=4)
    tds = twsi.WSIDataset(tmp_path / "datalist.json", patch_size=TILE, max_patches=4)
    assert tds.get_labels() == jds.get_labels() == [1, 0]
    for i in range(2):
        _same_item(jds.get_item(i, np.random.default_rng(i)),
                   tds.get_item(i, np.random.default_rng(i)))
    assert twsi.tissue_fraction(img[:TILE, :TILE]) == jwsi.tissue_fraction(img[:TILE, :TILE])


# ----------------------------------------------------------------- tools

def test_feature_tools_match_jax(tmp_path):
    """check_feature_files (ok, missing, corrupt coords, non-finite, empty,
    unreadable) reports as JAX's; merge_to_hdf5_dir writes files that both
    packages and h5py read back the same."""
    r = np.random.default_rng(5)
    feats = r.standard_normal((5, 8)).astype(np.float32)
    h5.write(tmp_path / "good.h5", {"features": feats, "coords": np.zeros((5, 2), np.int32)})
    h5.write(tmp_path / "badcoords.h5", {"features": feats, "coords": np.zeros((3, 2), np.int32)})
    nan = feats.copy()
    nan[0, 0] = np.nan
    h5.write(tmp_path / "nan.h5", {"features": nan})
    h5.write(tmp_path / "empty.h5", {"features": np.zeros((0, 8), np.float32)})
    (tmp_path / "garbage.h5").write_bytes(b"not an hdf5 file")
    np.save(tmp_path / "a.npy", feats)
    labels = {"train": [["good", 1], ["badcoords.h5", 0], ["missing.h5", 0]],
              "val": [["nan.h5", 1], ["empty.h5", 0]], "test": [["garbage.h5", 1], ["a.npy", 0]]}
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    want = jtools.check_feature_files(tmp_path, tmp_path / "labels.json")
    got = ttools.check_feature_files(tmp_path, tmp_path / "labels.json")
    assert got.summary() == want.summary() == {"ok": 2, "missing": 1, "corrupt": 3, "empty": 1,
                                               "feature_dims": {8: 2}}
    assert (got.ok, got.missing, got.empty) == (want.ok, want.missing, want.empty)
    assert [c[0] for c in got.corrupt] == [c[0] for c in want.corrupt]

    torch.save(torch.from_numpy(feats), tmp_path / "b.pt")
    sources = [tmp_path / "a.npy", tmp_path / "b.pt", tmp_path / "good.h5"]
    jout = jtools.merge_to_hdf5_dir(sources, tmp_path / "jax")
    tout = ttools.merge_to_hdf5_dir(sources, tmp_path / "port")
    assert [p.name for p in tout] == [p.name for p in jout] == ["a.h5", "b.h5", "good.h5"]
    for jp, tp in zip(jout, tout):
        with h5py.File(jp, "r") as jf, h5py.File(tp, "r") as tf:
            assert sorted(tf) == sorted(jf) == ["coords", "features"]
            for key in jf:
                assert tf[key].dtype == jf[key].dtype and tf[key][()].tobytes() == jf[key][()].tobytes()
        back = h5.read(jp)
        assert back["features"].tobytes() == h5.read(tp)["features"].tobytes()
    assert ttools.merge_to_hdf5_dir(sources[:1], tmp_path / "port") == tout[:1]  # kept


# ------------------------------------------------------------------- h5

def test_h5_files_read_both_ways(tmp_path):
    """utils/h5 writes what h5py reads back (dtype, shape, bytes) and reads
    what h5py writes by default: many datasets (a B-tree of several
    levels), compact and big-endian data, never-written datasets, attributes.
    What it does not read raises naming it (chunked and gzip data are read:
    test_h5_reads_chunked_datasets)."""
    r = np.random.default_rng(6)
    arrays = {"features": r.standard_normal((37, 16)).astype(np.float32),
              "coords": r.integers(0, 99, (37, 2)).astype(np.int32),
              "images": r.integers(0, 256, (3, 4, 4, 3), dtype=np.uint8),
              "empty": np.zeros((0, 2), np.float32), "f64": r.standard_normal(5),
              "f16": r.standard_normal(7).astype(np.float16), "i64": np.arange(4)}
    arrays.update({f"t{i:03d}": np.full((2,), i, np.int16) for i in range(120)})
    h5.write(tmp_path / "port.h5", arrays)
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert sorted(f) == sorted(arrays)
        for k, v in arrays.items():
            assert f[k].dtype == v.dtype and f[k].shape == v.shape
            assert f[k][()].tobytes() == v.tobytes()
    back = h5.read(tmp_path / "port.h5")
    assert list(back) == sorted(arrays)
    assert all(back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
               for k, v in arrays.items())

    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        for t in range(300):
            f[f"tile_{t:04d}"] = np.full((2, 2, 3), t % 256, np.uint8)
        f.create_dataset("be", data=np.arange(6, dtype=">f4").reshape(2, 3))
        f.create_dataset("unwritten", shape=(3, 4), dtype=np.float32)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE, h5py.h5s.create_simple((5,)),
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype=np.int16))
        f.attrs["note"] = 1
        f["be"].attrs["x"] = np.arange(50)
        f["scalar"] = np.float64(2.5)
    got = h5.read(tmp_path / "h5py.h5")
    with h5py.File(tmp_path / "h5py.h5", "r") as f:
        assert list(got) == sorted(f)
        for k in f:
            assert got[k].dtype == f[k].dtype and got[k].shape == f[k].shape
            assert got[k].tobytes() == np.asarray(f[k][()]).tobytes()

    for name, make in {
        r"filter 32000 \(lzf\)": lambda f: f.create_dataset("a", data=np.ones(9),
                                                          compression="lzf"),
        r"filter 3 \(fletcher32\)": lambda f: f.create_dataset("a", data=np.ones(9),
                                                             fletcher32=True),
        "variable-length datatype": lambda f: f.__setitem__("a", "text"),
        "group 'g'": lambda f: f.create_group("g").__setitem__("a", np.ones(2)),
    }.items():
        with h5py.File(tmp_path / "bad.h5", "w") as f:
            make(f)
        with pytest.raises(h5.UnsupportedHDF5, match=name):
            h5.read(tmp_path / "bad.h5")
    with h5py.File(tmp_path / "latest.h5", "w", libver="latest") as f:
        f["a"] = np.ones(3)
    with pytest.raises(h5.UnsupportedHDF5, match="superblock version"):
        h5.read(tmp_path / "latest.h5")


_CHUNKED = {
    # CLAM's feature files: resizable, one row a chunk (a chunk B-tree of 2 levels)
    "rows": lambda r: ({"data": r.standard_normal((203, 24)).astype(np.float32),
                        "maxshape": (None, 24), "chunks": (1, 24)}),
    "edges": lambda r: ({"data": r.integers(-9, 99, (13, 7, 3)).astype(np.int32),
                         "chunks": (4, 3, 2)}),
    "gzip": lambda r: ({"data": r.standard_normal((50, 33)), "compression": "gzip",
                        "compression_opts": 9}),
    "shuffle": lambda r: ({"data": r.integers(0, 256, (9, 8, 8, 3), dtype=np.uint8),
                           "compression": "gzip", "shuffle": True, "chunks": (2, 8, 8, 3)}),
    "shuffle16": lambda r: ({"data": r.standard_normal(1000).astype(np.float16),
                             "shuffle": True, "chunks": (64,)}),
    "big-endian": lambda r: ({"data": np.arange(40, dtype=">i4").reshape(8, 5),
                              "chunks": (3, 5), "compression": "gzip"}),
}


@pytest.mark.parametrize("case", sorted(_CHUNKED))
def test_h5_reads_chunked_datasets(tmp_path, case):
    """Chunked datasets, with and without the deflate and shuffle filters,
    read as h5py reads them; where a chunk was never written, the dataset's
    fill value; a dataset grown after it was written."""
    r = np.random.default_rng(len(case))
    kwargs = _CHUNKED[case](r)
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("a", **kwargs)
        d = f.create_dataset("partly", shape=(10, 6), dtype=np.int16, chunks=(3, 4),
                             fillvalue=-7, **{k: v for k, v in kwargs.items()
                                              if k in ("compression", "shuffle")})
        d[4:6, 1:3] = 5
        g = f.create_dataset("grown", data=np.arange(12.0).reshape(4, 3), maxshape=(None, 3),
                             chunks=(2, 3))
        g.resize((7, 3))
        g[5:] = -1.0
    got = h5.read(tmp_path / "c.h5")
    with h5py.File(tmp_path / "c.h5", "r") as f:
        assert list(got) == sorted(f)
        for k in f:
            assert got[k].dtype == f[k].dtype and got[k].shape == f[k].shape
            assert got[k].tobytes() == np.asarray(f[k][()]).tobytes()


# -------------------------------------------------------------- pipeline

def test_pipeline_matches_jax():
    """prefetch keeps the order and raises the producer's error in the
    consumer; a consumer that stops early releases the thread;
    shard_for_host splits as JAX's; device_prefetch on the CPU yields each
    batch with its arrays as tensors."""
    items = list(range(23))
    for hosts in (1, 2, 3, 5):
        shards = [tpipeline.shard_for_host(items, h, hosts) for h in range(hosts)]
        assert shards == [jpipeline.shard_for_host(items, h, hosts) for h in range(hosts)]
        assert sum(shards, []) == items
    assert tpipeline.shard_for_host(items) == items
    assert list(tpipeline.prefetch(iter(items), size=2, transform=lambda x: 2 * x)) == [
        2 * x for x in items]

    def failing():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(tpipeline.prefetch(failing()))
    gen = tpipeline.prefetch(iter(range(1000)), size=1)
    assert next(gen) == 0
    gen.close()

    batches = [(np.full((2, 3), i, np.float32), np.arange(2), None) for i in range(4)]
    out = list(tpipeline.device_prefetch(iter(batches), torch.device("cpu"), lambda b: b))
    assert [o[0] for o in out] == batches
    for (bag, labels, coords), (_, tb, tl, tc) in zip(batches, out):
        assert torch.equal(tb, torch.from_numpy(bag)) and torch.equal(tl, torch.from_numpy(labels))
        assert tc is None
