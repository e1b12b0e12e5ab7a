"""MILDataModule (port of ``data/datamodule.py``): the dataset of each
stage and its batch iterators.

Batches are numpy, as in the JAX package, and the same seed gives the same
batches byte for byte: the imbalanced sampler's draws, the ``max_bag_size``
subsample, mixup, the zero pad and the post-pad shuffle of every train bag
replay the JAX module's numpy draws. Train bags are fixed at
``max_bag_size``; eval bags keep their length (``eval_pad='exact'``, the
reference evaluates unpadded bags) or pad to a bucket (``'bucket'``).

Sources: synthetic bags (``synthetic={...}``) or per-slide feature bags from
``data_dir`` named in the label JSON ``label_path``
(:class:`~transmil_deepgraft_tpu_torch.data.feature_bags.FeatureBagDataset`),
whose train batches may come from the native bag store
(:meth:`MILDataModule.enable_bagstore`). The other dataset variants
(spatial, images, tiles, image_bags) and the Camelyon source are not ported
yet (ROADMAP A6/A7) and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from transmil_deepgraft_tpu_torch.data.coords import normalize_pad_coords
from transmil_deepgraft_tpu_torch.data.feature_bags import FeatureBagDataset, load_bag_file
from transmil_deepgraft_tpu_torch.data.sampler import ImbalancedSampler
from transmil_deepgraft_tpu_torch.data.synthetic import SyntheticBagDataset
from transmil_deepgraft_tpu_torch.ops.padding import DEFAULT_BUCKETS, bucket_for_length

__all__ = ["Batch", "MILDataModule", "collate", "normalize_pad_coords"]


@dataclass
class Batch:
    bags: np.ndarray  # (B, N, D) float32
    labels: np.ndarray  # (B,) int32
    lengths: np.ndarray  # (B,) int32 real bag lengths before padding
    names: list[str]
    patients: list[str]
    coords: list[np.ndarray]
    # (B, N, 2) float32 tile grid coords aligned with ``bags`` rows, or None
    padded_coords: np.ndarray | None = None


def _pad_to(bag: np.ndarray, n: int) -> np.ndarray:
    if bag.shape[0] >= n:
        return bag[:n]
    return np.concatenate([bag, np.zeros((n - bag.shape[0], *bag.shape[1:]), bag.dtype)], axis=0)


def collate(items: Sequence[tuple], eval_pad: str = "bucket") -> Batch:
    """Stack ``(bag, label, (name, coords, patient))`` items into a
    :class:`Batch`, zero-padding bags to the longest (``'exact'``) or to its
    bucket of ``DEFAULT_BUCKETS``."""
    bags = [i[0] for i in items]
    lengths = np.array([b.shape[0] for b in bags], np.int32)
    max_len = int(lengths.max())
    target = max_len if eval_pad == "exact" else bucket_for_length(max_len, DEFAULT_BUCKETS)
    coords = [np.asarray(i[2][1]) for i in items]
    padded_coords = None
    if all(c.ndim == 2 and c.shape[0] == b.shape[0] and c.shape[1] == 2 and c.any()
           for c, b in zip(coords, bags)):
        padded_coords = np.stack([normalize_pad_coords(c, target) for c in coords])
    bags = np.stack([_pad_to(b, target) for b in bags]).astype(np.float32)
    return Batch(
        bags=bags,
        labels=np.array([i[1] for i in items], np.int32),
        lengths=lengths,
        names=[i[2][0] for i in items],
        coords=coords,
        patients=[i[2][2] for i in items],
        padded_coords=padded_coords,
    )


def _mixup_assembled(bags: np.ndarray, taken: np.ndarray, rng: np.random.Generator) -> None:
    """In-place bag mixup on a (B, k, D) batch from the bag store, with the
    draws of ``FeatureBagDataset._mixup_bag``: a full bag is replaced by the
    convex combinations, a short one gets them appended into its zero pad."""
    k = bags.shape[1]
    for i in range(bags.shape[0]):
        n = int(taken[i])
        if n <= 0:
            continue
        view = bags[i, :n]
        a = rng.random(n, dtype=np.float32)[:, None]
        temp = a * view[rng.integers(0, n, n)] + (1.0 - a) * view[rng.integers(0, n, n)]
        if n < k:
            m = min(n, k - n)
            bags[i, n:n + m] = temp[rng.permutation(n)[:m]]
        else:
            bags[i] = temp


class MILDataModule:
    def __init__(self, data_dir: str | None = None, label_path: str | None = None, *,
                 n_classes: int = 2, max_bag_size: int = 1000, batch_size: int = 1,
                 mixup: bool = False, feature_extractor: str | None = None,
                 slide_patient_path: str | None = None, use_imbalanced_sampler: bool = True,
                 eval_pad: str = "exact", seed: int = 2021, synthetic: dict | None = None,
                 fine_tune: bool = False, dataset_name: str = "custom", fold: int = 0,
                 variant: str = "features", mixed_res_dirs: list | None = None,
                 tile_size: int = 224, resample_val: bool = False) -> None:
        if synthetic is None and dataset_name == "camelyon":
            raise NotImplementedError("the Camelyon source is not ported yet (ROADMAP A6)")
        if synthetic is None and variant != "features":
            raise NotImplementedError(
                f"dataset variant {variant!r} is not ported yet (ROADMAP A6/A7); "
                "the port has 'features'")
        self.data_dir = data_dir
        self.label_path = label_path
        self.n_classes = n_classes
        self.max_bag_size = max_bag_size
        self.batch_size = batch_size
        self.mixup = mixup
        self.feature_extractor = feature_extractor
        self.slide_patient_path = slide_patient_path
        self.use_imbalanced_sampler = use_imbalanced_sampler
        self.eval_pad = eval_pad
        self.seed = seed
        self.synthetic = synthetic
        self.fine_tune = fine_tune
        self.dataset_name = dataset_name
        self.fold = fold
        self.variant = variant
        self.mixed_res_dirs = mixed_res_dirs
        self.tile_size = tile_size  # read by the image variants only
        self.resample_val = resample_val  # the reference's val sampler (off by default)
        self._datasets: dict = {}
        self._bagstore = None

    def enable_bagstore(self, path: str | None = None, rebuild: bool = False,
                        n_threads: int = 8) -> None:
        """Draw train batches from the native bag store, packed once from the
        train split's files (default ``<data_dir>/train_cohort.bags``):
        sampling and batch assembly in C++ threads. Mixup and the post-pad
        reshuffle run on the assembled batch."""
        from transmil_deepgraft_tpu_torch.data.bagstore import BagStore, write_bagstore

        ds = self.dataset("train")
        store_path = Path(path) if path else Path(self.data_dir) / "train_cohort.bags"
        if rebuild or not store_path.exists():
            bags, coords = zip(*(load_bag_file(f) for f in ds.files))
            write_bagstore(store_path, bags, coords)
        self._bagstore = BagStore(store_path)
        self._bagstore_labels = np.asarray(ds.get_labels(), np.int32)
        self._bagstore_meta = (list(ds.names), list(ds.patients))
        self._bagstore_threads = n_threads
        self._bagstore_ntiles = np.array(
            [self._bagstore.n_tiles(i) for i in range(self._bagstore.n_slides)], np.int64)

    def _make_dataset(self, mode: str):
        if self.synthetic is not None:
            cfg = dict(self.synthetic)
            n = {"train": cfg.pop("n_train", 32), "val": cfg.pop("n_val", 16),
                 "test": cfg.pop("n_test", 16)}["train" if mode == "fine_tune" else mode]
            seed = {"train": 0, "fine_tune": 0, "val": 1, "test": 2}[mode]
            ds = SyntheticBagDataset(n_slides=n, n_classes=self.n_classes, seed=seed, **cfg)
            if mode in ("train", "fine_tune"):
                return _TrainViewSynthetic(ds, self.max_bag_size)
            return _EvalViewSynthetic(ds)
        actual_mode = "fine_tune" if (mode == "train" and self.fine_tune) else mode
        return FeatureBagDataset(
            self.data_dir, self.label_path, actual_mode, self.n_classes,
            slide_patient_path=self.slide_patient_path, max_bag_size=self.max_bag_size,
            mixup=self.mixup and mode in ("train", "fine_tune"),
            feature_extractor=self.feature_extractor, mixed_res_dirs=self.mixed_res_dirs,
        )

    def dataset(self, mode: str):
        if mode not in self._datasets:
            self._datasets[mode] = self._make_dataset(mode)
        return self._datasets[mode]

    def train_batches(self, epoch: int) -> Iterator[Batch]:
        ds = self.dataset("train")
        rng = np.random.default_rng((self.seed, epoch))
        if self.use_imbalanced_sampler:
            order = ImbalancedSampler(ds.get_labels(), self.n_classes).sample_epoch(rng)
        else:
            order = rng.permutation(len(ds))
        bs = self.batch_size
        if self._bagstore is not None:
            yield from self._bagstore_batches(order, rng)
            return
        for start in range(0, len(order) - bs + 1, bs):
            items = [ds.get_item(int(i), rng) for i in order[start:start + bs]]
            yield collate(items, eval_pad="exact")  # train bags are already fixed-size

    def _bagstore_batches(self, order: np.ndarray, rng: np.random.Generator) -> Iterator[Batch]:
        names, patients = self._bagstore_meta
        bs, k = self.batch_size, self.max_bag_size
        for start in range(0, len(order) - bs + 1, bs):
            idxs = order[start:start + bs]
            bags = self._bagstore.assemble_batch(idxs, k=k, seed=int(rng.integers(2**31)),
                                                 n_threads=self._bagstore_threads)
            if self.mixup:
                _mixup_assembled(bags, np.minimum(self._bagstore_ntiles[idxs], k), rng)
            # the post-pad reshuffle (ref feature_dataloader.py:363-365): the
            # pad rows land at random positions of TransMIL's square grid
            perm = rng.random((bs, k)).argsort(axis=1)
            bags = np.take_along_axis(bags, perm[:, :, None], axis=1)
            yield Batch(bags=bags, labels=self._bagstore_labels[idxs],
                        lengths=np.full(bs, k, np.int32), names=[names[i] for i in idxs],
                        patients=[patients[i] for i in idxs],
                        coords=[np.zeros((0, 2), np.int32)] * bs)

    def eval_batches(self, mode: str, batch_size: int = 1) -> Iterator[Batch]:
        ds = self.dataset(mode)
        rng = np.random.default_rng(0)
        order = np.arange(len(ds))
        if mode == "val" and self.resample_val:
            order = ImbalancedSampler(ds.get_labels(), self.n_classes).sample_epoch(rng)
        for start in range(0, len(order), batch_size):
            items = [ds.get_item(int(i), rng) for i in order[start:start + batch_size]]
            yield collate(items, eval_pad=self.eval_pad)

    def steps_per_epoch(self) -> int:
        return len(self.dataset("train")) // self.batch_size


class _TrainViewSynthetic:
    """The feature-bag train sampling on synthetic bags: a random subsample
    of ``max_bag_size`` tiles, zero pad, then a shuffle of the padded bag."""

    def __init__(self, ds: SyntheticBagDataset, max_bag_size: int) -> None:
        self.ds = ds
        self.max_bag_size = max_bag_size

    def __len__(self) -> int:
        return len(self.ds)

    def get_labels(self):
        return self.ds.get_labels()

    def get_item(self, index: int, rng: np.random.Generator):
        feats, label, (name, coords, patient) = self.ds[index]
        idx = rng.permutation(feats.shape[0])[:self.max_bag_size]
        bag = _pad_to(feats[idx], self.max_bag_size)
        coords = normalize_pad_coords(np.asarray(coords)[idx], bag.shape[0])
        perm = rng.permutation(bag.shape[0])
        return bag[perm], label, (name, coords[perm], patient)


class _EvalViewSynthetic:
    def __init__(self, ds: SyntheticBagDataset) -> None:
        self.ds = ds

    def __len__(self) -> int:
        return len(self.ds)

    def get_labels(self):
        return self.ds.get_labels()

    def get_item(self, index: int, rng: np.random.Generator):
        return self.ds[index]
