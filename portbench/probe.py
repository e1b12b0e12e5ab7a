#!/usr/bin/env python3
"""Readings for setting the limits, in one process a call.

    python3 portbench/probe.py --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--side program|control] [--plant <fault>]

Runs the cell once a seed (a short window at the cell's own load, then its
check) and prints each seed's compared numbers as a JSON line: the
program's (``program``), the reference at the next lower precision in its
place (``control``), or the program with a fault planted in its timed path
(``--plant``). The benchmark's own runs (``run.py``) run none of this.
"""

import run  # noqa: F401  (run.py's preamble: the caches inside the checkout, the checkout on the path)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--side", default="program", choices=("program", "control"))
    ap.add_argument("--plant", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, _, out = harness.outcome(args.workload, seed, args.seconds, dev, side=args.side,
                                    plant=args.plant)
        print(json.dumps({"seed": seed, "side": args.side, "plant": args.plant, "log": out.log,
                          "correct": out.correct,
                          "checks": {k: v for k, (v, _) in out.checks.items()},
                          "metrics": out.metrics, "attempted": out.attempted,
                          "failed": out.failed, "wall_s": time.perf_counter() - t0}), flush=True)
        print("\n".join(out.log), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
