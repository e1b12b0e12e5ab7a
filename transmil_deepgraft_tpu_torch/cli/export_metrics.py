"""Metric-export CLI (port of ``cli/export_metrics.py``):
``python -m transmil_deepgraft_tpu_torch.cli.export_metrics``.

The reference's ``utils/export_metrics.py`` driver surface (``make_parse``,
``export_metrics.py:144-198``): aggregate finished runs into bootstrap-CI
summaries, a combined CSV, and multi-run comparison figures (ROC overlay, AUROC
bars, PR overlay, confusion-matrix grid)."""

from __future__ import annotations

import argparse


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="aggregate run metrics + comparison figures")
    p.add_argument("--runs", nargs="+", default=None,
                   help="explicit run dirs holding TEST_RESULT_PATIENT.csv")
    p.add_argument("--log_root", default=None,
                   help="scan a project log tree instead of naming runs (the "
                        "reference's get_data discovery: "
                        "{log_root}/{project}/{model}/{task}/_{backbone}_{loss})")
    p.add_argument("--project", default=None, help="log-tree filter")
    p.add_argument("--model", default=None, help="log-tree filter")
    p.add_argument("--filter_task", default=None, help="log-tree filter")
    p.add_argument("--task", default="")
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--out_csv", default="combined_metrics.csv")
    return p


def main(argv: list[str] | None = None) -> None:
    from transmil_deepgraft_tpu_torch.utils.export_metrics import export_combined, scan_log_tree

    args = make_parser().parse_args(argv)
    runs = list(args.runs or [])
    if args.log_root:
        found = scan_log_tree(args.log_root, project=args.project,
                              model=args.model, task=args.filter_task)
        print(f"log tree: {len(found)} runs under {args.log_root}")
        runs += [r["dir"] for r in found]
    if not runs:
        raise SystemExit("no runs: pass --runs and/or --log_root")
    export_combined(runs, task=args.task, n_classes=args.n_classes,
                    out_csv=args.out_csv)
    print(f"wrote {args.out_csv} (+ comparison figures alongside)")


if __name__ == "__main__":
    main()
