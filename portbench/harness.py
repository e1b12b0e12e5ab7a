"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Finds the cell's configuration (``configs`` entry -> its file), traffic
(``traffic/<name>.json``, which names its runner) and, with ``--trace 1``,
its per-layer metrics (``metrics/<name>.py``, each a ``read(ctx)`` that
returns a number or None) by the names in the manifest. A cell, a
configuration, a traffic mix or a metric is added as files and manifest
entries; no file here changes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import costs, runners

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transmil_deepgraft_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of the cell ``name``."""
    man = manifest(root)
    by_name = {w["name"]: w for w in man["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(by_name)}")
    work = by_name[name]
    entry = {c["name"]: c for c in man["configs"]}[work["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{work['traffic']}.json").read_text())
    return work, config, traffic


def cell_metrics(name: str, kind: str, root: Path = ROOT) -> list[dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    man = manifest(root)
    e2e_here = {m["name"] for m in man["end_to_end"]
                if name in m.get("workloads", [name])}
    out = []
    for m in man[kind]:
        cells = m.get("workloads")
        if cells is not None:
            here = name in cells
        else:
            here = kind == "end_to_end" or m["moves"] in e2e_here
        if here:
            out.append(m)
    return out


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    name = "portbench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def outcome(name: str, seed: int, seconds: float, device: torch.device, *, traced: bool = False,
            root: Path = ROOT, side: str = "program", plant: str | None = None):
    """Run the cell once: (its workload entry, its configuration, the runner's
    ``Outcome``)."""
    work, config, traffic = cell_parts(name, root)
    cell = runners.Cell(name=name, config=config, traffic=traffic, seed=seed, seconds=seconds,
                        trace=traced, device=device, side=side, plant=plant)
    return work, config, runners.run(cell)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t0: float, root: Path = ROOT) -> dict:
    """Run the cell and return its result line as a dict (``checks`` last)."""
    work, config, out = outcome(name, seed, seconds, device, traced=traced, root=root)
    for line in out.log:
        print(line, file=sys.stderr)
    metrics = {}
    if traced:
        view = out.trace
        ctx = SimpleNamespace(trace=view, work=out.work, config=config, costs=costs, cell=name)
        for m in cell_metrics(name, "per_layer", root):
            value = reader(m["name"], root)(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell_metrics(name, "end_to_end", root):
            if m["name"] == "setup_s":
                value = out.window_start - t0
            else:
                value = out.metrics[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(work["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    work, _, _ = cell_parts(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        print(f"portbench: the cell {args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
