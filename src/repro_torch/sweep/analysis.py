"""The separate analysis pass: render ``points.jsonl`` into reports.

``python -m repro_torch.sweep <config> --analyze`` re-reads the (possibly
partial) log and renders it through the renderer the config names:

* ``table``    — generic ``summary.json`` + ``summary.md`` (one row
  per point: the axis values and the measure's scalar columns).
* ``pareto``   — the accuracy-vs-TOPS/W report (``<model>.json`` +
  ``.md``) with the frontier recomputed across *all* ok points via
  :func:`repro_torch.core.calibrate.mark_frontier` — the same domination
  rule ``CalibrationResult.pareto`` applies, so a study run through
  the sweep harness draws the same frontier as the in-process API.
* ``autotune`` — a :class:`~repro_torch.kernels.autotune.TuningCache`
  file (``<arch>.tuning.json``) built from the measured winners, seeded
  from the active cache directory's ``<arch>.json``
  (``autotune.default_cache_dir``), ready to copy there.

Analysis is pure rendering: it never executes measures, and running it
twice (or after a resume) produces byte-identical outputs. Every
artifact is stamped with the report version and the sweep's
``config_hash``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable

from repro_torch.sweep import report as report_lib
from repro_torch.sweep import runner as runner_lib
from repro_torch.sweep.config import SweepConfig

Renderer = Callable[[SweepConfig, list[dict]], list[pathlib.Path]]

_RENDERERS: dict[str, Renderer] = {}


def register(name: str, fn: Renderer) -> None:
    _RENDERERS[name] = fn


def registered() -> tuple[str, ...]:
    return tuple(sorted(_RENDERERS))


def analyze(config: SweepConfig) -> list[pathlib.Path]:
    """Render the sweep's log; returns the written artifact paths."""
    if config.analysis not in _RENDERERS:
        raise ValueError(
            f"unknown analysis {config.analysis!r}; "
            f"registered: {list(registered())}"
        )
    records = sorted(
        runner_lib.read_points(config).values(), key=lambda r: r["index"]
    )
    if not records:
        raise ValueError(
            f"no points recorded at {config.points_path}; run the sweep "
            f"first (python -m repro_torch.sweep <config>)"
        )
    return _RENDERERS[config.analysis](config, records)


# ---------------------------------------------------------------------------
# table — generic summary
# ---------------------------------------------------------------------------


def _scalar_columns(records: list[dict]) -> list[str]:
    cols: list[str] = []
    for r in records:
        for k, v in (r.get("result") or {}).items():
            if k not in cols and (
                v is None or isinstance(v, (str, int, float, bool))
            ):
                cols.append(k)
    return cols


def _render_table(
    config: SweepConfig, records: list[dict]
) -> list[pathlib.Path]:
    axes = sorted(config.axes)
    cols = _scalar_columns(records)
    summary = {
        "version": report_lib.REPORT_VERSION,
        "config_hash": config.config_hash,
        "name": config.name,
        "model": config.model,
        "measure": config.measure,
        "n_points": len(records),
        "n_ok": sum(r["status"] == "ok" for r in records),
        "n_skipped": sum(r["status"] == "skipped" for r in records),
        "points": records,
    }
    out = config.sweep_dir
    jpath = out / "summary.json"
    jpath.write_text(json.dumps(summary, indent=2, sort_keys=True) + "\n")

    def fmt(v):
        return "—" if v is None else str(v)

    lines = [
        f"# Sweep summary — {config.name} "
        f"({summary['n_ok']} ok / {summary['n_skipped']} skipped, "
        f"config {config.config_hash})",
        "",
        "| # | " + " | ".join(axes + cols + ["status"]) + " |",
        "|" + "---|" * (len(axes) + len(cols) + 2),
    ]
    for r in records:
        res = r.get("result") or {}
        row = [str(r["index"])]
        row += [fmt(r["point"].get(a)) for a in axes]
        row += [fmt(res.get(c)) for c in cols]
        row.append(r["status"] if r["status"] == "ok"
                   else f"skipped: {r.get('reason', '')}")
        lines.append("| " + " | ".join(row) + " |")
    mpath = out / "summary.md"
    mpath.write_text("\n".join(lines) + "\n")
    return [jpath, mpath]


register("table", _render_table)


# ---------------------------------------------------------------------------
# pareto — frontier across all ok points
# ---------------------------------------------------------------------------


def _render_pareto(
    config: SweepConfig, records: list[dict]
) -> list[pathlib.Path]:
    from repro_torch.core import calibrate as cal

    ok = [r for r in records if r["status"] == "ok"]
    if not ok:
        raise ValueError(
            f"{config.name}: no ok points to render a pareto report from"
        )
    raw = [
        (r["result"]["variant"], float(r["result"]["vdd"]),
         float(r["result"]["tops_per_w"]), float(r["result"]["score"]),
         r["result"].get("accuracy"))
        for r in ok
    ]
    points = cal.mark_frontier(raw)
    meta = ok[0]["result"]
    payload = report_lib.pareto_payload(
        config.model, points,
        cost_unit=meta.get("cost_unit", "fJ/MAC"),
        slack=meta.get("slack"),
        grid=meta.get("grid"),
        config_hash=config.config_hash,
    )
    jpath, mpath = report_lib.write_payload(payload, config.sweep_dir)
    return [jpath, mpath]


register("pareto", _render_pareto)


# ---------------------------------------------------------------------------
# autotune — tuning-cache file from measured winners
# ---------------------------------------------------------------------------


def _render_autotune(
    config: SweepConfig, records: list[dict]
) -> list[pathlib.Path]:
    from repro_torch.kernels import autotune

    ok = [r for r in records if r["status"] == "ok"]
    if not ok:
        raise ValueError(
            f"{config.name}: no ok points to build a tuning cache from"
        )
    arch = str(config.params.get("arch", "cpu"))
    # Seed from the active per-arch cache (when present): the
    # output then carries every previously pinned cell, a bumped
    # sweep_version on the freshly measured ones, and a "stale" list
    # naming whatever this sweep did NOT re-measure — the --analyze
    # staleness surface for partial re-sweeps.
    prev = autotune.TuningCache.load(arch=arch)
    cache = autotune.cache_from_records(
        arch,
        (
            {
                "variant": r["result"]["variant"],
                "cell": r["result"]["cell"],
                "backend": r["result"]["backend"],
                "block": r["result"]["block"],
                "us": r["result"]["us"],
            }
            for r in ok
        ),
        prev=prev,
    )
    payload = cache.to_json()
    payload["config_hash"] = config.config_hash
    payload["stale"] = list(autotune.stale_entries(cache))
    path = config.sweep_dir / f"{arch}.tuning.json"
    path.write_text(json.dumps(payload, indent=1, sort_keys=True))
    return [path]


register("autotune", _render_autotune)
