"""CLI: ``python -m repro_torch.sweep <config> [--dry-run | --analyze]``.

  PYTHONPATH=src python -m repro_torch.sweep \
      configs/sweeps/accuracy_study.json
  PYTHONPATH=src python -m repro_torch.sweep \
      configs/sweeps/accuracy_study.json --dry-run
  PYTHONPATH=src python -m repro_torch.sweep \
      configs/sweeps/accuracy_study.json --analyze

Default mode executes (or resumes) the sweep, on the card unless the
config's ``params.device`` is ``"cpu"``: completed point IDs in
``<out_dir>/points.jsonl`` (default ``build/sweeps/<name>``) are
skipped, new records append, and a completed log finalizes to grid
order. ``--dry-run`` validates the config, output paths and every grid
point's feasibility bounds without executing a measure; ``--analyze``
renders the existing log into the config's report format. Exit codes:
0 on success (a dry-run with infeasible points still exits 0 — those
points become recorded skips), 2 on a config/usage error.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.sweep import analysis, measures, runner
from repro_torch.sweep.config import load_config


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="config-driven, resumable experiment sweeps",
    )
    ap.add_argument("config", nargs="?",
                    help="sweep config (.json or .py)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dry-run", action="store_true",
                      help="validate config + grid feasibility, no "
                           "execution")
    mode.add_argument("--analyze", action="store_true",
                      help="render points.jsonl into the config's "
                           "report format")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="process-parallel grid points (default 1)")
    ap.add_argument("--max-points", type=int, default=None, metavar="N",
                    help="execute at most N new points this invocation")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="override the config's output directory")
    ap.add_argument("--list-measures", action="store_true",
                    help="print registered measures and exit")
    args = ap.parse_args(argv)

    if args.list_measures:
        for name in measures.registered():
            print(name)
        return 0
    if not args.config:
        ap.print_usage(sys.stderr)
        print("error: a sweep config is required", file=sys.stderr)
        return 2

    try:
        config = load_config(args.config)
        if args.out:
            import pathlib

            config = config.override(
                out_dir=str(pathlib.Path(args.out).resolve())
            )
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.dry_run:
        try:
            records = runner.dry_run(config)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        bad = [r for r in records if not r["feasible"]]
        print(f"[{config.name}] config {config.config_hash}: "
              f"{len(records)} grid points, {len(records) - len(bad)} "
              f"feasible, {len(bad)} would be skipped "
              f"-> {config.points_path}")
        for r in records:
            mark = "ok  " if r["feasible"] else "SKIP"
            extra = "" if r["feasible"] else f"  ({r['reason']})"
            print(f"  {mark} {r['index']:>3} {r['point_id']} "
                  f"{r['point']}{extra}")
        return 0

    if args.analyze:
        try:
            paths = analysis.analyze(config)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for p in paths:
            print(f"wrote {p}")
        return 0

    report = runner.run(
        config, jobs=max(args.jobs, 1), max_points=args.max_points
    )
    if report.finalized:
        print(f"run `python -m repro_torch.sweep {args.config} --analyze` "
              f"to render the report")
    return 0


if __name__ == "__main__":
    sys.exit(main())
