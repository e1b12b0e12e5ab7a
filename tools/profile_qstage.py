#!/usr/bin/env python3
"""Where the time of the int8 stage kernels goes (``csrc/qstage.cu``), per
convolution and per phase of the kernel's loop.

    python3 tools/profile_qstage.py [--phases]

Builds the int8 ResNet50 of ``chip_smoke.py`` (seeded random full-width
weights, 8 calibration tiles) on the GPU and runs the seven segments of one
128-tile chunk at 224x224 through ``qstage_run`` / ``qentry_run``. Prints for
each launch (three a bottleneck: conv1, conv2, conv3 with the identity or the
downsample) its device time from ``torch.profiler`` (median of 5), the bytes
and int8 operations it needs (inputs read once, output written once) as GB/s
and TOP/s, and its floor at 3.35 TB/s and 1,979 TOP/s.

``--phases`` also builds a copy of ``csrc/qstage.cu`` with ``clock64()``
stamps around the phases of the K loop (into ``build/``; the source in the
package is not touched) and prints, for each kernel instantiation, the clocks
thread 0 spends per K tile waiting for its copies, at the barrier, issuing the
next K tile's copies, on the products (issue and wait), and on the epilogue
(per K tile, over the tiles). The stamps cost a few percent.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (text in csrc/qstage.cu, text of the instrumented copy)
PHASE_PATCHES = [
    ("  uint32_t hw_mul, hw_shr, w_mul, w_shr;\n};\n",
     "  uint32_t hw_mul, hw_shr, w_mul, w_shr;\n};\n__device__ unsigned long long g_phase[128];\n"),
    ("  for (int it = 0; it < items; ++it) {\n"
     "    // K tile it is in; every warpgroup is done with it - 1, whose stage takes it + S - 1.\n"
     "    cp_async_wait<S - 2>();\n    __syncthreads();\n"
     "    const int nxt = it + S - 1;\n    if (nxt < items) load(nxt % S);\n    cp_async_commit();\n",
     "  unsigned long long pw = 0, pb = 0, pl = 0, pm = 0, pe = 0, tt;\n"
     "  for (int it = 0; it < items; ++it) {\n    tt = clock64();\n    cp_async_wait<S - 2>();\n"
     "    pw += clock64() - tt;\n    tt = clock64();\n    __syncthreads();\n"
     "    pb += clock64() - tt;\n    tt = clock64();\n"
     "    const int nxt = it + S - 1;\n    if (nxt < items) load(nxt % S);\n    cp_async_commit();\n"
     "    pl += clock64() - tt;\n    tt = clock64();\n"),
    ("    } else {\n      mma(acc);\n    }\n    if (!last) {",
     "    } else {\n      mma(acc);\n    }\n    pm += clock64() - tt;\n    tt = clock64();\n"
     "    if (!last) {"),
    ("            *reinterpret_cast<const uint4*>(stage + r * T::OSTR + 16 * c);\n    }\n  }\n"
     "  cp_async_wait<0>();\n}",
     "            *reinterpret_cast<const uint4*>(stage + r * T::OSTR + 16 * c);\n    }\n"
     "    pe += clock64() - tt;\n  }\n  cp_async_wait<0>();\n  if (tid == 0) {\n"
     "    unsigned long long* g = g_phase + 8 * (EPI * 4 + (TAPS == 9) * 2 + (BN == 128));\n"
     "    atomicAdd(g + 0, pw);\n    atomicAdd(g + 1, pb);\n    atomicAdd(g + 2, pl);\n"
     "    atomicAdd(g + 3, pm);\n    atomicAdd(g + 4, pe);\n"
     "    atomicAdd(g + 5, (unsigned long long)items);\n  }\n}"),
    ("const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }",
     "const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }\n"
     "int qstage_phase_read(unsigned long long* out) {\n  cudaDeviceSynchronize();\n"
     "  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n"
     "  unsigned long long zero[128] = {};\n"
     "  return cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n}"),
]
EPI_NAMES = ("conv1", "conv2", "conv3+id", "conv3+ds")


def phase_library():
    """The instrumented copy of csrc/qstage.cu, built into build/, with the
    wrapper's C signatures."""
    from transmil_deepgraft_tpu_torch.ops import _build
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk

    src = (_build.CSRC / "qstage.cu").read_text()
    for old, new in PHASE_PATCHES:
        if old not in src:
            raise SystemExit(f"profile_qstage: csrc/qstage.cu no longer has the text the phase "
                             f"stamps go around: {old[:60]!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "qstage_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "qstage_phases.cu").write_text(src)
    so = out / "libqstage_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out / "qstage_phases.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.qstage_run.argtypes = [P] * 6 + [ctypes.POINTER(qk._QBlockArgs), I, I, I, I, P]
    lib.qentry_run.argtypes = [P] * 4 + [ctypes.POINTER(qk._QBlockArgs), I, I, I, P]
    lib.qstage_run.restype = lib.qentry_run.restype = I
    lib.cuda_error_string.argtypes = [I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_costs(blocks, entry: bool, x_shape) -> list:
    """(label, least bytes, int8 operations) of each launch of a segment."""
    n, h, w, _ = x_shape
    stride = 2 if entry else 1
    costs = []
    for blk in blocks:
        cin, mid = blk.w1.shape[-2:]
        cout = blk.w3.shape[-1]
        rows, rows_out = n * h * w, n * (h // stride) * (w // stride)
        ds = blk.wd is not None
        costs += [("conv1", rows * (cin + mid), 2 * rows * cin * mid),
                  ("conv2", rows * mid + rows_out * mid, 2 * rows_out * 9 * mid * mid),
                  ("conv3+ds" if ds else "conv3+id", rows_out * (mid + cin + cout),
                   2 * rows_out * cout * (mid + (cin if ds else 0)))]
        h, w = h // stride, w // stride
    return costs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", action="store_true", help="also time the loop's phases")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_qstage: needs a CUDA GPU", file=sys.stderr)
        return 2
    from chip_smoke import (CALIB_TILES, CHUNK, TILE, normalize_tiles,
                            random_resnet50_variables, segment_runs, segments)
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import _stem_q, build_qresnet50
    from transmil_deepgraft_tpu_torch.ops import qstage_kernel as qk

    rng = np.random.default_rng(0)
    variables = random_resnet50_variables(rng)
    tiles = rng.integers(0, 256, (CHUNK, TILE, TILE, 3), dtype=np.uint8)
    q = build_qresnet50(variables, normalize_tiles(tiles[:CALIB_TILES]), device="cuda")
    print(f"{torch.cuda.get_device_name(0)}; one {CHUNK}-tile chunk of {TILE}x{TILE}")
    with torch.inference_mode():
        x0 = _stem_q(q, torch.from_numpy(normalize_tiles(tiles)).cuda())
        x = x0
        for (name, _, run, _), (_, blocks, entry) in zip(segment_runs(q), segments(q)):
            costs = launch_costs(blocks, entry, tuple(x.shape))
            for _ in range(2):
                run(x)
            torch.cuda.synchronize()
            for _attempt in range(3):  # the profiler now and then drops a kernel's events
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run(x)
                    torch.cuda.synchronize()
                evs = [e for e in prof.events()
                       if e.device_type.name == "CUDA" and "conv_kernel" in e.name]
                if len(evs) == 5 * len(costs):
                    break
            else:
                print(f"{name}: the profiler dropped events; no per-launch times")
                x = run(x)
                continue
            total = 0.0
            for i, (label, nbytes, ops) in enumerate(costs):
                us = float(np.median([evs[i + len(costs) * r].device_time for r in range(5)]))
                total += us
                tmpl = re.search(r"conv_kernel<([^>]*)>", evs[i].name)
                print(f"{name} block {i // 3} {label:9s} <{tmpl.group(1) if tmpl else '?'}> "
                      f"{us:8.1f} us {nbytes / us / 1e3:7.1f} GB/s {ops / us / 1e6:7.1f} TOP/s "
                      f"floor {max(nbytes / 3.35e6, ops / 1979e6):6.1f} us")
            print(f"{name}: {total:.1f} us over {len(costs)} launches")
            x = run(x)

        if args.phases:
            lib = phase_library()
            qk._library = lambda: lib
            buf = (ctypes.c_ulonglong * 128)()
            x = x0
            print("clocks of thread 0 per K tile: wait for copies, barrier, issue copies, "
                  "products, epilogue (spread over the K tiles)")
            for (name, _, run, _), (_, blocks, entry) in zip(segment_runs(q), segments(q)):
                lib.qstage_phase_read(buf)  # zero the counters
                out = run(x)
                lib.qstage_phase_read(buf)
                for slot in range(16):
                    v = list(buf[8 * slot:8 * slot + 6])
                    if not v[5]:
                        continue
                    epi, rest = divmod(slot, 4)
                    print(f"  {name} {EPI_NAMES[epi]:9s} N tile {128 if rest % 2 else 64:3d}: "
                          + " ".join(f"{k} {t / v[5]:.0f}" for k, t in
                                     zip(("wait", "barrier", "copies", "products", "epilogue"),
                                         v[:5]))
                          + f" ({v[5]} K tiles)")
                x = out
    return 0


if __name__ == "__main__":
    sys.exit(main())
