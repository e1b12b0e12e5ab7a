#!/usr/bin/env python3
"""Where the time of one served feature bag goes, in the PyTorch/CUDA port.

    python3 tools/profile_torch_request.py [--tiles 40960] [--reps 3] [--trace PATH]

Serves one bag of ``--tiles`` random 2048-d features through the port's
``ServingBundle`` (TransMIL head, seeded random weights, buckets up to 65,536)
on the GPU and prints, for the last of ``--reps`` requests:

* host phases on the host clock, each ended by ``torch.cuda.synchronize()``:
  validation, host-to-device copy of the real rows + zero pad on the device,
  the forward, by stage (fc1,
  square pad + cls, TransLayer 1, PPEG, TransLayer 2, head), device-to-host;
* device time by kernel from ``torch.profiler`` over one whole request, and
  the device's busy share of that request's wall time.

``--trace PATH`` also writes the profiler's chrome trace to PATH.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def stage_times(model, x, sync) -> dict:
    """Host-clock ms of each stage of TransMIL.forward (fused inference), each
    ended by a synchronize, mirroring models/transmil.py."""
    import torch

    from transmil_deepgraft_tpu_torch.ops.padding import duplicate_pad_square

    out, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    h = model._fc1(x)
    mark("fc1")
    h, gh, gw = duplicate_pad_square(h)
    h = torch.cat([model.cls_token.expand(h.shape[0], -1, -1), h], dim=1)
    mark("square pad + cls")
    h, _ = model._run_layer(model.layer1, h, True, None)
    mark("TransLayer 1")
    h = model.pos_layer(h, gh, gw)
    mark("PPEG")
    h, _ = model._run_layer(model.layer2, h, True, None)
    mark("TransLayer 2")
    model._fc(model.norm(h)[:, 0])
    mark("norm + fc")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=40960)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", type=Path, default=None, help="write the chrome trace here")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_request: needs a CUDA GPU", file=sys.stderr)
        return 2
    from chip_smoke import SMOKE_BUCKETS, random_transmil_params
    from transmil_deepgraft_tpu_torch.serving import ServingBundle, export_serving_bundle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "head.tdx"
        export_serving_bundle(random_transmil_params(rng, 2048, 2), path, model_name="TransMIL",
                              in_features=2048, n_classes=2, buckets=SMOKE_BUCKETS)
        bundle = ServingBundle.load(path)
    bag = rng.standard_normal((args.tiles, 2048)).astype(np.float32)
    dev = bundle.device

    def sync():
        torch.cuda.synchronize(dev)

    for _ in range(args.reps):
        phases = {}
        t0 = time.perf_counter()
        _, target, bags = bundle._prepare_inputs(bag)
        phases["validate (host)"] = (time.perf_counter() - t0) * 1e3
        t = time.perf_counter()
        x = bundle._device_bags(bags, target, len(bags))
        sync()
        phases["host-to-device + bucket pad"] = (time.perf_counter() - t) * 1e3
        with torch.inference_mode():
            stages = stage_times(bundle.model, x, sync)
            t = time.perf_counter()
            logits = bundle.model(x)
            sync()
            t_fwd = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            logits.cpu().numpy()
            phases["device-to-host"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        bundle.predict_logits(bag)
        t_request = (time.perf_counter() - t) * 1e3

    print(f"{torch.cuda.get_device_name(0)}; tiles {args.tiles}, bucket {target}")
    print(f"predict_logits, whole request: {t_request:.2f} ms; forward alone: {t_fwd:.2f} ms")
    for name, ms in phases.items():
        print(f"  {name:28s} {ms:9.2f} ms")
    for name, ms in stages.items():
        print(f"  forward: {name:19s} {ms:9.2f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bundle.predict_logits(bag)
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled request: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12))
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    print(json.dumps({"tiles": args.tiles, "request_ms": t_request, "forward_ms": t_fwd,
                      "phases_ms": phases, "stages_ms": stages, "busy_ms": busy_ms,
                      "profiled_wall_ms": wall_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
