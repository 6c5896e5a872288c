"""Resumable sweep execution over the append-only ``points.jsonl`` log.

Execution contract:

* Every grid point produces exactly one JSON record in
  ``<sweep_dir>/points.jsonl``, stamped with ``version``,
  ``config_hash``, ``index``, ``point_id`` and either
  ``status="ok"`` + ``result`` or ``status="skipped"`` + ``reason``.
* The log is **append-only during execution**: a record is written the
  moment its point completes, so a killed run loses at most the
  in-flight points. On restart, :func:`read_points` recovers the
  completed ``point_id`` set (tolerating one torn trailing line from
  the kill) and the runner executes only the remainder.
* When the last point lands, the runner **finalizes**: the log is
  rewritten sorted by grid index. Records carry no timestamps and all
  floats are rounded, so an interrupted-and-resumed run finalizes to a
  file byte-identical to an uninterrupted one — and to a
  ``--jobs N`` run, whose mid-flight append order is scheduler-
  dependent (this is the "deterministic result ordering on merge").
* A log whose ``version`` or ``config_hash`` doesn't match the config
  is rejected with a clear error: edit the config → new hash → point
  at a fresh out_dir (or delete the stale log).

Feasibility-rejected points (``--dry-run`` semantics, re-checked at
run time) are *recorded* as skips, not errors — an infeasible grid
corner is an artifact of the study.

``--jobs N`` runs points in a pool of ``spawn`` workers: each starts
CUDA afresh, so the parent's own CUDA state is never inherited.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Mapping

from repro_torch.sweep import measures as measures_lib
from repro_torch.sweep import plan as plan_lib
from repro_torch.sweep.config import SWEEP_VERSION, SweepConfig


def _round_floats(v: Any, nd: int = 6) -> Any:
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return round(v, nd)
    if isinstance(v, (list, tuple)):
        return [_round_floats(x, nd) for x in v]
    if isinstance(v, Mapping):
        return {str(k): _round_floats(v[k], nd) for k in v}
    raise TypeError(
        f"measure result value {v!r} ({type(v).__name__}) is not JSON data"
    )


def record_line(rec: Mapping[str, Any]) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def read_points(
    config: SweepConfig, path: pathlib.Path | str | None = None
) -> dict[str, dict]:
    """point_id -> record from an existing log; {} when none exists.

    Rejects version/config-hash mismatches loudly. A torn final line
    (interrupted mid-append) is dropped — that point simply re-runs —
    but a malformed line anywhere else means real corruption and
    raises.
    """
    path = pathlib.Path(path) if path else config.points_path
    if not path.exists():
        return {}
    out: dict[str, dict] = {}
    lines = path.read_text().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn trailing append from an interrupted run
            raise ValueError(
                f"{path}:{i + 1}: corrupt record (not valid JSON)"
            ) from None
        if rec.get("version") != SWEEP_VERSION:
            raise ValueError(
                f"{path}: record version {rec.get('version')!r} != "
                f"{SWEEP_VERSION}; this log was written by an "
                f"incompatible sweep harness — move it aside or re-run"
            )
        if rec.get("config_hash") != config.config_hash:
            raise ValueError(
                f"{path}: config_hash {rec.get('config_hash')!r} != "
                f"{config.config_hash!r} for sweep '{config.name}' — "
                f"the config changed since this log was written. Point "
                f"the config at a fresh out_dir or delete the stale log."
            )
        out[rec["point_id"]] = rec
    return out


def _make_record(
    config: SweepConfig,
    point: plan_lib.GridPoint,
    *,
    status: str,
    result: Mapping[str, Any] | None = None,
    reason: str | None = None,
) -> dict:
    rec = {
        "version": SWEEP_VERSION,
        "config_hash": config.config_hash,
        "index": point.index,
        "point_id": point.point_id,
        "point": point.canonical(),
        "status": status,
    }
    if status == "ok":
        rec["result"] = _round_floats(dict(result or {}))
    else:
        rec["reason"] = str(reason)
    return rec


def run_point(config: SweepConfig, point: plan_lib.GridPoint) -> dict:
    """Execute one grid point; SkipPoint becomes a skipped record."""
    measure = measures_lib.resolve(config.measure)
    try:
        result = measure.fn(config, point)
    except measures_lib.SkipPoint as e:
        return _make_record(config, point, status="skipped", reason=str(e))
    return _make_record(config, point, status="ok", result=result)


def _worker(config_dict: dict, index: int) -> dict:
    """Process-pool entrypoint: rebuild the config, run one point."""
    config = SweepConfig.from_dict(config_dict)
    point = plan_lib.expand(config)[index]
    return run_point(config, point)


def point_reason(
    config: SweepConfig, point: plan_lib.GridPoint
) -> str | None:
    """Full dry-run validation for one point (measure + physics)."""
    measure = measures_lib.resolve(config.measure)
    if measure.validate is not None:
        reason = measure.validate(config, point)
        if reason is not None:
            return reason
    return plan_lib.validate_point(config, point)


def dry_run(config: SweepConfig) -> list[dict]:
    """Validate the config, I/O paths and every grid point; no execution.

    Returns one record per point: ``{"index", "point_id", "point",
    "feasible", "reason"}``. Raises on an unknown measure, an
    unwritable output dir, or an existing log that belongs to a
    different config/version.
    """
    import os

    measures_lib.resolve(config.measure)  # unknown measure raises
    # Writable output path, without creating anything on a dry run.
    probe = config.sweep_dir
    while not probe.exists() and probe.parent != probe:
        probe = probe.parent
    if not (probe.is_dir() and os.access(probe, os.W_OK)):
        raise ValueError(
            f"output dir {config.sweep_dir} is not creatable "
            f"({probe} is not a writable directory)"
        )
    read_points(config)  # stale/mismatched log raises
    out = []
    for point in plan_lib.expand(config):
        reason = point_reason(config, point)
        out.append({
            "index": point.index,
            "point_id": point.point_id,
            "point": point.canonical(),
            "feasible": reason is None,
            "reason": reason,
        })
    return out


@dataclasses.dataclass(frozen=True)
class RunReport:
    """What one ``run`` invocation did to the log."""

    name: str
    config_hash: str
    points_path: pathlib.Path
    n_points: int
    n_prior: int  # completed before this invocation (resume skips)
    n_ok: int  # executed ok this invocation
    n_skipped: int  # recorded as infeasible this invocation
    finalized: bool  # log complete + rewritten in grid order

    @property
    def complete(self) -> bool:
        return self.finalized


def run(
    config: SweepConfig,
    *,
    jobs: int = 1,
    max_points: int | None = None,
    log: Callable[[str], None] = print,
) -> RunReport:
    """Execute (or resume) a sweep; see the module docstring contract.

    ``max_points`` caps how many points this invocation *executes*
    (completed-prior and infeasible-skip records don't count) — the
    deterministic stand-in for "killed mid-run" in tests and a way to
    chunk long sweeps.
    """
    points = plan_lib.expand(config)
    config.sweep_dir.mkdir(parents=True, exist_ok=True)
    existing = read_points(config)
    path = config.points_path
    if path.exists():
        # Repair a torn trailing line before appending after it —
        # otherwise the next append would glue onto the partial write.
        valid = "".join(
            record_line(r) + "\n" for r in existing.values()
        )
        if path.read_text() != valid:
            path.write_text(valid)
    pending = [p for p in points if p.point_id not in existing]
    n_prior = len(points) - len(pending)
    if n_prior:
        log(f"[{config.name}] resume: {n_prior}/{len(points)} points "
            f"already in {config.points_path}")

    # Pre-validate: infeasible points become skip records immediately
    # (they are grid facts, not work).
    to_run: list[plan_lib.GridPoint] = []
    new_records: list[dict] = []
    for p in pending:
        reason = point_reason(config, p)
        if reason is None:
            to_run.append(p)
        else:
            new_records.append(
                _make_record(config, p, status="skipped", reason=reason)
            )
            log(f"[{config.name}] skip point {p.index} "
                f"({p.point_id}): {reason}")

    if max_points is not None:
        to_run = to_run[:max_points]

    with path.open("a") as f:
        for rec in new_records:
            f.write(record_line(rec) + "\n")
        f.flush()
        n_ok = 0
        if jobs > 1 and len(to_run) > 1:
            import concurrent.futures as cf
            import multiprocessing as mp

            cfg_dict = config.to_dict()
            ctx = mp.get_context("spawn")
            with cf.ProcessPoolExecutor(
                max_workers=jobs, mp_context=ctx
            ) as pool:
                futs = {
                    pool.submit(_worker, cfg_dict, p.index): p
                    for p in to_run
                }
                for fut in cf.as_completed(futs):
                    rec = fut.result()
                    f.write(record_line(rec) + "\n")
                    f.flush()
                    new_records.append(rec)
                    n_ok += rec["status"] == "ok"
                    if rec["status"] != "ok":
                        log(f"[{config.name}] skip point "
                            f"{rec['index']}: {rec['reason']}")
        else:
            for p in to_run:
                rec = run_point(config, p)
                f.write(record_line(rec) + "\n")
                f.flush()
                new_records.append(rec)
                n_ok += rec["status"] == "ok"
                if rec["status"] != "ok":
                    log(f"[{config.name}] skip point {p.index}: "
                        f"{rec['reason']}")

    # Finalize: complete logs are rewritten in grid order, making the
    # on-disk bytes independent of execution/append order.
    all_recs = read_points(config)
    finalized = len(all_recs) == len(points)
    if finalized:
        ordered = sorted(all_recs.values(), key=lambda r: r["index"])
        path.write_text(
            "".join(record_line(r) + "\n" for r in ordered)
        )
    n_skipped = sum(r["status"] == "skipped" for r in new_records)
    log(f"[{config.name}] {n_ok} ok, {n_skipped} skipped, "
        f"{n_prior} prior; "
        + ("finalized " + str(path) if finalized
           else f"{len(points) - len(all_recs)} points still pending"))
    return RunReport(
        name=config.name,
        config_hash=config.config_hash,
        points_path=path,
        n_points=len(points),
        n_prior=n_prior,
        n_ok=n_ok,
        n_skipped=n_skipped,
        finalized=finalized,
    )
