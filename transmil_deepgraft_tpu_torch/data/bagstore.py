"""The native bag store through ctypes (port of ``data/bagstore.py``).

A store packs the per-slide (n_i, D) float32 bags and (n_i, 2) int32 coords
of a cohort into one file that is memory-mapped on open: a full-bag read is
one copy from the page cache, ``sample_bag`` copies only the sampled rows,
and ``assemble_batch`` fills a whole (B, k, D) train batch from native
threads. The format is the JAX package's, so either package reads the
other's stores.

``native/bagstore.cpp`` is a copy of the JAX package's source, byte for
byte; ``g++`` compiles it at first use, through ``data/native_tiles.build``,
into
``build/native/<sha of source and flags>/libbagstore.so`` under the
repository root (without the JAX build's ``-march=native``: the library must
run on whatever host the checkout lands on).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import numpy as np

from transmil_deepgraft_tpu_torch.data import native_tiles

SOURCE = Path(__file__).resolve().parents[1] / "native" / "bagstore.cpp"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_tiles.build(SOURCE, libs=())))
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    signatures = {
        "bagstore_open": (vp, [ctypes.c_char_p]),
        "bagstore_close": (None, [vp]),
        "bagstore_n_slides": (u64, [vp]),
        "bagstore_dim": (u64, [vp]),
        "bagstore_n_tiles": (u64, [vp, u64]),
        "bagstore_read_bag": (ctypes.c_int, [vp, u64, vp]),
        "bagstore_read_coords": (ctypes.c_int, [vp, u64, vp]),
        "bagstore_sample_bag": (ctypes.c_int64, [vp, u64, u64, u64, ctypes.c_int, vp, vp]),
        "bagstore_assemble_batch": (ctypes.c_int, [vp, vp, u64, u64, u64, ctypes.c_int, vp]),
        "bagstore_write": (ctypes.c_int, [ctypes.c_char_p, u64, u64, vp, vp, vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def write_bagstore(
    path: str | Path,
    bags: Sequence[np.ndarray],
    coords: Sequence[np.ndarray] | None = None,
) -> Path:
    """Pack per-slide (n_i, D) float32 bags (+ (n_i, 2) int32 coords) into one store."""
    lib = _library()
    dim = bags[0].shape[1]
    n_tiles = np.array([b.shape[0] for b in bags], np.uint64)
    all_feats = np.ascontiguousarray(np.concatenate(bags).astype(np.float32))
    if coords is None:
        coords = [np.zeros((b.shape[0], 2), np.int32) for b in bags]
    all_coords = np.ascontiguousarray(np.concatenate(coords).astype(np.int32))
    rc = lib.bagstore_write(str(path).encode(), len(bags), dim, _ptr(n_tiles),
                            _ptr(all_feats), _ptr(all_coords))
    if rc != 0:
        raise IOError(f"bagstore_write failed for {path}")
    return Path(path)


def convert_h5_dir(h5_dir: str | Path, out_path: str | Path,
                   names: list[str] | None = None) -> tuple[Path, list[str]]:
    """Pack a directory of per-slide ``.h5`` feature files into one store."""
    import h5py

    h5_dir = Path(h5_dir)
    files = sorted(h5_dir.glob("*.h5")) if names is None else [h5_dir / f"{n}.h5" for n in names]
    bags, coords, slide_names = [], [], []
    for f in files:
        with h5py.File(f, "r") as h:
            bags.append(np.asarray(h["features"][:], np.float32))
            coords.append(
                np.asarray(h["coords"][:], np.int32) if "coords" in h
                else np.zeros((bags[-1].shape[0], 2), np.int32)
            )
        slide_names.append(f.stem)
    return write_bagstore(out_path, bags, coords), slide_names


class BagStore:
    def __init__(self, path: str | Path) -> None:
        self._lib = _library()
        self._handle = self._lib.bagstore_open(str(path).encode())
        if not self._handle:
            raise IOError(f"cannot open bag store {path}")
        self.n_slides = int(self._lib.bagstore_n_slides(self._handle))
        self.dim = int(self._lib.bagstore_dim(self._handle))

    def close(self) -> None:
        if getattr(self, "_handle", None):  # None too when __init__ failed
            self._lib.bagstore_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def _slide(self, slide: int) -> int:
        if not 0 <= slide < self.n_slides:
            raise IndexError(slide)
        return int(slide)

    def n_tiles(self, slide: int) -> int:
        return int(self._lib.bagstore_n_tiles(self._handle, self._slide(slide)))

    def read_bag(self, slide: int) -> np.ndarray:
        out = np.empty((self.n_tiles(slide), self.dim), np.float32)
        if self._lib.bagstore_read_bag(self._handle, slide, _ptr(out)) != 0:
            raise IndexError(slide)
        return out

    def read_coords(self, slide: int) -> np.ndarray:
        out = np.empty((self.n_tiles(slide), 2), np.int32)
        if self._lib.bagstore_read_coords(self._handle, slide, _ptr(out)) != 0:
            raise IndexError(slide)
        return out

    def sample_bag(self, slide: int, k: int, seed: int, pad: bool = True) -> tuple[np.ndarray, int]:
        """(k, D) rows of a seeded draw without replacement (zero-padded when
        the slide has fewer than k tiles) and the number of real rows."""
        out = np.empty((k, self.dim), np.float32)
        taken = self._lib.bagstore_sample_bag(self._handle, self._slide(slide), k, seed,
                                              int(pad), _ptr(out), None)
        if taken < 0:
            raise IndexError(slide)
        return out, int(taken)

    def assemble_batch(self, slides: Sequence[int], k: int, seed: int,
                       n_threads: int = 8) -> np.ndarray:
        """(B, k, D): ``sample_bag`` of each slide, filled by native threads."""
        slides_arr = np.asarray(slides, np.uint64)
        if len(slides_arr) and int(slides_arr.max()) >= self.n_slides:
            raise IndexError(int(slides_arr.max()))
        out = np.empty((len(slides_arr), k, self.dim), np.float32)
        rc = self._lib.bagstore_assemble_batch(self._handle, _ptr(slides_arr), len(slides_arr),
                                               k, seed, n_threads, _ptr(out))
        if rc != 0:
            raise RuntimeError("assemble_batch failed")
        return out
