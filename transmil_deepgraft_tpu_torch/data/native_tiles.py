"""The threaded JPEG tile loader (``native/tileloader.cpp``) through ctypes:
the port's counterpart of ``data/native_tiles.py``.

A C++ thread pool decodes a batch of JPEG tiles with libjpeg, resizes them
bilinearly and writes one (N, size, size, 3) buffer, raw uint8 or
ImageNet-normalized float32. The source is a copy of the JAX package's,
byte for byte; it is compiled with ``g++`` at first use into
``build/native/<sha of source and flags>/libtileloader.so`` under the
repository root (the JAX package's own ``native/`` directory is never
written).

:func:`available` is False when the build or a one-tile self-test fails
(no compiler, no libjpeg, no PIL to write the probe): callers then decode
with PIL, as the JAX package's callers do. This is the host's decoder
choice; nothing on the device depends on it. The module logs which decoder
the process has.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from transmil_deepgraft_tpu_torch.data.tiles import IMAGENET_MEAN, IMAGENET_STD

SOURCE = Path(__file__).resolve().parents[1] / "native" / "tileloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
# The JAX package's Makefile flags, less -mtune (the code is the same).
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

log = logging.getLogger(__name__)


def library_path() -> Path:
    """Where ``libtileloader.so`` for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libtileloader.so"


def build() -> Path:
    """Compile the loader if it is not built yet; raises with the compiler's
    output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp, "-ljpeg"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    """The built, self-tested loader, or None (once a process)."""
    try:
        lib = ctypes.CDLL(str(build()))
        lib.tl_load_batch.restype = ctypes.c_int
        lib.tl_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.tl_load_batch_u8.restype = ctypes.c_int
        lib.tl_load_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ]
        _selftest(lib)
    except (OSError, RuntimeError, ImportError) as e:
        log.info("native JPEG tile loader unavailable (%s); tiles decode with PIL",
                 str(e).splitlines()[0] if str(e) else type(e).__name__)
        return None
    log.info("native JPEG tile loader (libjpeg, threaded): %s", library_path())
    return lib


def _selftest(lib: ctypes.CDLL) -> None:
    """Decode one small mid-gray JPEG through the library: catches a build
    that loads but decodes wrong."""
    from PIL import Image

    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "probe.jpg"
        Image.fromarray(np.full((8, 8, 3), 128, np.uint8)).save(p, quality=95)
        out = np.empty((1, 8, 8, 3), np.uint8)
        arr = (ctypes.c_char_p * 1)(str(p).encode())
        rc = lib.tl_load_batch_u8(arr, 1, 8, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                  1, 0)
        if rc != 1 or abs(float(out.mean()) - 128.0) > 8.0:
            raise RuntimeError("native tile loader self-test failed")


def available() -> bool:
    return _library() is not None


def _paths(paths: Sequence[str | Path]):
    return (ctypes.c_char_p * len(paths))(*[os.fspath(p).encode() for p in paths])


def _threads(n_threads: int | None) -> int:
    return n_threads or min(16, os.cpu_count() or 4)


def _lib_or_raise() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("native tile loader unavailable (libjpeg / build failed)")
    return lib


def load_tiles(
    paths: Sequence[str | Path],
    size: int = 224,
    n_threads: int | None = None,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
    scaled_dct: bool = False,
) -> tuple[np.ndarray, int]:
    """Decode ``paths`` -> ((N, size, size, 3) normalized float32, n_ok); a
    tile that fails to decode stays zero. ``scaled_dct`` decodes sources of
    at least 2x ``size`` at a reduced libjpeg DCT scale before the resize."""
    lib = _lib_or_raise()
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.float32)
    if n == 0:
        return out, 0
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    n_ok = lib.tl_load_batch(
        _paths(paths), n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _threads(n_threads), mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(scaled_dct))
    return out, int(n_ok)


def load_tiles_u8(
    paths: Sequence[str | Path],
    size: int = 224,
    n_threads: int | None = None,
    scaled_dct: bool = False,
) -> tuple[np.ndarray, int]:
    """Decode ``paths`` -> ((N, size, size, 3) raw uint8, n_ok), for the
    path that normalizes on the device. ``scaled_dct``: see
    :func:`load_tiles`."""
    lib = _lib_or_raise()
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    if n == 0:
        return out, 0
    n_ok = lib.tl_load_batch_u8(
        _paths(paths), n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _threads(n_threads), int(scaled_dct))
    return out, int(n_ok)
