#!/usr/bin/env python3
"""Where the time of the slide embed goes, in the PyTorch/CUDA port.

    python3 tools/profile_torch_embed.py [--slide-tiles 40960] [--reps 3] [--trace PATH]

Builds the int8 ResNet50 of ``chip_smoke.py`` (seeded random full-width
weights, 8 calibration tiles) inside a ``SlideInferencePipeline`` with a
TransMIL-2048 head on the GPU, and prints:

* the phases of one 128-tile uint8 chunk's embed on the host clock, each
  ended by ``torch.cuda.synchronize()``: host-to-device copy, normalization,
  the stem (quantize, space-to-depth, int8 conv as a float64 matmul, requant,
  max-pool), each of the seven int8 segments (stage/entry kernels), the pool;
* device time by kernel from ``torch.profiler`` over one chunk's embed, and
  the device's busy share of its wall time;
* one ``predict_slide`` of ``--slide-tiles`` uint8 tiles (the chunk repeated)
  on the host clock, after a warm-up slide of one chunk, and the slides per
  second that makes.

Both kernel sources are built before anything is timed.

``--trace PATH`` also writes the profiler's chrome trace to PATH.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slide-tiles", type=int, default=40960)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", type=Path, default=None, help="write the chrome trace here")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_embed: needs a CUDA GPU", file=sys.stderr)
        return 2
    from chip_smoke import (
        CALIB_TILES, CHUNK, TILE, normalize_tiles, random_resnet50_variables,
        random_transmil_params, segment_runs)
    from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.models.resnet_int8 import _pool, _stem_q
    from transmil_deepgraft_tpu_torch.ops import _build
    from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax

    _build.build()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    variables = random_resnet50_variables(rng)
    batch = rng.integers(0, 256, (CHUNK, TILE, TILE, 3), dtype=np.uint8)
    head = create_model("TransMIL", 2, 2048)
    head.load_state_dict(state_dict_from_jax(random_transmil_params(rng, 2048, 2), 2048))
    pipe = SlideInferencePipeline(variables, head, calib_tiles=normalize_tiles(batch[:CALIB_TILES]),
                                  chunk=CHUNK)
    q, dev = pipe._q, pipe.device

    def sync():
        torch.cuda.synchronize(dev)

    pipe.predict_slide(batch)  # warm-up: allocator, cuBLAS handles, both libraries loaded
    sync()
    for _ in range(args.reps):
        phases, t = {}, time.perf_counter()

        def mark(name):
            nonlocal t
            sync()
            now = time.perf_counter()
            phases[name] = (now - t) * 1e3
            t = now

        with torch.inference_mode():
            x = torch.from_numpy(batch).to(dev)
            mark("host-to-device (uint8, pageable)")
            x = (x.float() / 255.0 - pipe._mean) / pipe._std
            mark("normalize")
            out = _stem_q(q, x)
            mark("stem (float64 matmul) + max-pool")
            for name, kernel, run, _ in segment_runs(q):
                out = run(out)
                mark(f"{name} ({kernel})")
            _pool(q, out)
            mark("average pool")
        t = time.perf_counter()
        pipe._embed_chunk(batch)
        sync()
        chunk_ms = (time.perf_counter() - t) * 1e3

    print(f"{torch.cuda.get_device_name(0)}; one {CHUNK}-tile uint8 chunk of {TILE}x{TILE}")
    print(f"_embed_chunk, whole: {chunk_ms:.2f} ms; by phase:")
    for name, ms in phases.items():
        print(f"  {name:36s} {ms:9.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe._embed_chunk(batch)
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled chunk: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    tiles = np.empty((args.slide_tiles, TILE, TILE, 3), np.uint8)
    for start in range(0, args.slide_tiles, CHUNK):
        tiles[start:start + CHUNK] = batch[:args.slide_tiles - start]
    t = time.perf_counter()
    probs = pipe.predict_slide(tiles)
    slide_ms = (time.perf_counter() - t) * 1e3
    print(f"predict_slide, {args.slide_tiles} uint8 tiles: {slide_ms:.1f} ms "
          f"({1e3 / slide_ms:.4f} slides/s), probs {probs.tolist()}")
    print(json.dumps({"chunk_ms": chunk_ms, "phases_ms": phases, "busy_ms": busy_ms,
                      "profiled_wall_ms": wall_ms, "slide_tiles": args.slide_tiles,
                      "slide_ms": slide_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
