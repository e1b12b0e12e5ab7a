"""MILDataModule over synthetic bags (port of ``data/datamodule.py``).

Batches are numpy, as in the JAX package, and the same seed gives the same
batches byte for byte: the imbalanced sampler's draws, the ``max_bag_size``
subsample, the zero pad and the post-pad shuffle of every train bag replay
the JAX module's numpy draws. Train bags are fixed at ``max_bag_size``; eval
bags keep their length (``eval_pad='exact'``, the reference evaluates
unpadded bags) or pad to a bucket (``'bucket'``).

This slice has the synthetic source only: feature bags from disk
(``data_dir``) raise; the bag store, mixup, the val resampling quirk and the
other dataset variants are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from transmil_deepgraft_tpu_torch.data.sampler import ImbalancedSampler
from transmil_deepgraft_tpu_torch.data.synthetic import SyntheticBagDataset
from transmil_deepgraft_tpu_torch.ops.padding import DEFAULT_BUCKETS, bucket_for_length


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


def normalize_pad_coords(coords: np.ndarray, target: int) -> np.ndarray:
    """(n, 2) real coords -> (target, 2) float32: per-axis min subtracted,
    zero rows appended (or the first ``target`` rows kept if n > target)."""
    c = np.asarray(coords, np.float32)
    if len(c):
        c = c - c.min(axis=0)
    if c.shape[0] >= target:
        return c[:target]
    return np.concatenate([c, np.zeros((target - c.shape[0], 2), np.float32)], axis=0)


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


class MILDataModule:
    def __init__(self, data_dir: str | None = None, label_path: str | None = None, *,
                 n_classes: int = 2, max_bag_size: int = 1000, batch_size: int = 1,
                 use_imbalanced_sampler: bool = True, eval_pad: str = "exact",
                 seed: int = 2021, synthetic: dict | None = None) -> None:
        if synthetic is None or data_dir is not None or label_path is not None:
            raise NotImplementedError(
                "the port's MILDataModule has the synthetic source only; feature bags "
                "from data_dir come in a later slice")
        self.n_classes = n_classes
        self.max_bag_size = max_bag_size
        self.batch_size = batch_size
        self.use_imbalanced_sampler = use_imbalanced_sampler
        self.eval_pad = eval_pad
        self.seed = seed
        self.synthetic = synthetic
        self._datasets: dict = {}

    def _make_dataset(self, mode: str):
        cfg = dict(self.synthetic)
        n = {"train": cfg.pop("n_train", 32), "val": cfg.pop("n_val", 16),
             "test": cfg.pop("n_test", 16)}[mode]
        seed = {"train": 0, "val": 1, "test": 2}[mode]
        ds = SyntheticBagDataset(n_slides=n, n_classes=self.n_classes, seed=seed, **cfg)
        return _TrainViewSynthetic(ds, self.max_bag_size) if mode == "train" else ds

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
        for start in range(0, len(order) - bs + 1, bs):
            items = [ds.get_item(int(i), rng) for i in order[start:start + bs]]
            yield collate(items, eval_pad="exact")  # train bags are already fixed-size

    def eval_batches(self, mode: str, batch_size: int = 1) -> Iterator[Batch]:
        ds = self.dataset(mode)
        for start in range(0, len(ds), batch_size):
            yield collate([ds[i] for i in range(start, min(start + batch_size, len(ds)))],
                          eval_pad=self.eval_pad)

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

