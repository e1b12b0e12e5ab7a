#!/usr/bin/env python3
"""Where the time of one training step goes, in the PyTorch/CUDA port.

    python3 tools/profile_torch_train.py [--tiles 1000] [--steps 8] [--trace PATH]

Trains TransMIL-2048 (seeded random weights, ``use_pallas=True``,
lookahead_radam with grad_acc 2, dropout on) through ``Trainer.train_step`` on
random bags of ``--tiles`` 2048-d features on the GPU and prints:

* each optimizer step (2 micro-steps) by part on the host clock, each part
  ended by ``torch.cuda.synchronize()``: forward, backward, optimizer update
  (medians over ``--steps`` steps after a warm-up one);
* the step as the trainer runs it (no synchronize between parts): median
  wall ms over ``--steps`` steps;
* device time by kernel from ``torch.profiler`` over one such optimizer step
  (the 15 largest, and the two Nystrom landmark kernels wherever they rank),
  and the device's busy share of that step's wall time.

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

GRAD_ACC = 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", type=Path, default=None, help="write the chrome trace here")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA GPU", file=sys.stderr)
        return 2
    from transmil_deepgraft_tpu_torch.data.datamodule import MILDataModule
    from transmil_deepgraft_tpu_torch.models import create_model
    from transmil_deepgraft_tpu_torch.train.losses import create_loss
    from transmil_deepgraft_tpu_torch.train.optimizers import create_optimizer
    from transmil_deepgraft_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = create_model("TransMIL", 2, 2048, use_pallas=True)
    tx = create_optimizer("lookahead_radam", lr=2e-4, weight_decay=0.01, grad_accum_steps=GRAD_ACC)
    dm = MILDataModule(n_classes=2, max_bag_size=args.tiles, synthetic={"feature_size": 2048})
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(model, tx, dm, n_classes=2, loss_fn=create_loss(),
                     config=TrainerConfig(log_dir=tmp))
    tx.init(model.parameters())
    rng = np.random.default_rng(0)
    n_micro = GRAD_ACC * (args.steps + 1)
    bags = torch.from_numpy(rng.standard_normal((n_micro, 1, args.tiles, 2048), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 2, (n_micro, 1))).to(dev)

    def sync():
        torch.cuda.synchronize(dev)

    parts = []
    for s in range(args.steps + 1):
        step = [0.0, 0.0, 0.0]
        for i in range(s * GRAD_ACC, (s + 1) * GRAD_ACC):
            for p in model.parameters():
                p.grad = None
            sync()
            t0 = time.perf_counter()
            loss, _ = tr.loss(bags[i], labels[i])
            sync()
            t1 = time.perf_counter()
            loss.backward()
            sync()
            t2 = time.perf_counter()
            tx.step()
            sync()
            t3 = time.perf_counter()
            for j, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                step[j] += dt * 1e3
        parts.append(step)
    parts = np.array(parts[1:])
    med = np.median(parts, axis=0)

    def trainer_step(s: int) -> None:
        for i in range(s * GRAD_ACC, (s + 1) * GRAD_ACC):
            tr.train_step(bags[i], labels[i])

    walls = []
    for s in range(args.steps + 1):
        sync()
        t = time.perf_counter()
        trainer_step(s)
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    step_ms = float(np.median(walls[1:]))

    print(f"{torch.cuda.get_device_name(0)}; TransMIL-2048, use_pallas, bags of {args.tiles} tiles, "
          f"grad_acc {GRAD_ACC}")
    print(f"one optimizer step by part (synchronized), median of {args.steps}: "
          f"{np.median(parts.sum(1)):.3f} ms = forward {med[0]:.3f} + backward {med[1]:.3f} "
          f"+ optimizer update {med[2]:.3f} ms")
    print(f"one optimizer step as Trainer.train_step runs it, median of {args.steps}: {step_ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t = time.perf_counter()
        trainer_step(0)
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"profiled optimizer step: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
          f"{launches} device ops")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    nystrom_ms = {}  # the landmark kernels (B5 landmark_attn, B6 query_lm), wherever they rank
    for e in events:
        for name in ("landmark_attn_kernel", "query_lm_kernel"):
            if name in e.key:
                nystrom_ms[name] = e.self_device_time_total / 1e3
                print(f"  Nystrom {name}: {nystrom_ms[name]:.3f} ms x{e.count} "
                      f"({100 * nystrom_ms[name] / busy_ms:.2f}% of device busy)")
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    print(json.dumps({"tiles": args.tiles, "step_ms": step_ms,
                      "parts_ms": {"forward": med[0], "backward": med[1], "update": med[2]},
                      "busy_ms": busy_ms, "profiled_wall_ms": wall_ms, "device_ops": launches,
                      "nystrom_kernels_ms": nystrom_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
