"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
that return a ``cudaError_t``) and includes no PyTorch header, so ``nvcc``
compiles it in seconds. The shared library lands in
``build/torch_kernels/<sha of the sources and flags>/lib<name>.so`` under the
repository root at first use; a later process with the same sources reuses it.
Pointers and the stream cross as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("translayer", "qstage", "nystrom")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``lib<name>.so`` for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` each, all started
    together. Returns ``{name: ptxas report}`` for the sources it compiled.
    Raises with nvcc's stderr when a build fails."""
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, so)
    reports, failures = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{err}{out}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        reports[name] = err + out
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so`` once per process."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib
