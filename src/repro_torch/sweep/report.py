"""Versioned pareto/summary report payloads (JSON + markdown).

The sweep analysis pass renders every accuracy-vs-TOPS/W report
through :func:`pareto_payload` / :func:`write_payload`, in the JAX
package's schema (``repro.sweep.report``) — stamped with
``REPORT_VERSION`` and (when produced by a sweep) the sweep's
``config_hash``, and :func:`load_report` rejects version mismatches
instead of mis-parsing old files.

Version history: v1 was the unstamped PR-5 format (no ``version``
key); v2 adds ``version`` + optional ``config_hash``. The point
schema is unchanged.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Iterable, Mapping

REPORT_VERSION = 2


def _round(x, nd: int = 6):
    return None if x is None else round(float(x), nd)


def pareto_payload(
    model: str,
    points: Iterable,  # ParetoPoint-shaped (attrs or mapping)
    *,
    cost_unit: str,
    slack: float | None,
    grid: Mapping[str, Any] | None,
    config_hash: str | None = None,
) -> dict:
    """The deterministic report dict (sorted keys, rounded floats)."""

    def get(p, k):
        return p[k] if isinstance(p, Mapping) else getattr(p, k)

    payload = {
        "version": REPORT_VERSION,
        "model": model,
        "cost_unit": cost_unit,
        "slack": _round(slack),
        "grid": (
            None if grid is None
            else {k: list(v) for k, v in sorted(dict(grid).items())}
        ),
        "points": [
            {
                "variant": get(p, "variant"),
                "vdd": _round(get(p, "vdd")),
                "tops_per_w": _round(get(p, "tops_per_w"), 4),
                "score": _round(get(p, "score")),
                "accuracy": _round(get(p, "accuracy")),
                "frontier": bool(get(p, "frontier")),
            }
            for p in points
        ],
    }
    if config_hash is not None:
        payload["config_hash"] = config_hash
    return payload


def markdown_table(payload: dict) -> str:
    lines = [
        f"# Pareto report — {payload['model']} (variants x vdd)",
        "",
        "| variant | vdd (V) | TOPS/W | rel-L2 | top-1 | frontier |",
        "|---|---|---|---|---|---|",
    ]
    for p in payload["points"]:
        acc = "—" if p["accuracy"] is None else f"{p['accuracy']:.4f}"
        star = "*" if p["frontier"] else ""
        lines.append(
            f"| {p['variant']} | {p['vdd']:.2f} | "
            f"{p['tops_per_w']:.2f} | {p['score']:.4f} | {acc} | "
            f"{star} |"
        )
    lines += ["", "`*` = on the accuracy-vs-TOPS/W frontier.", ""]
    return "\n".join(lines)


def write_payload(
    payload: dict, out_dir: pathlib.Path | str
) -> tuple[pathlib.Path, pathlib.Path]:
    """Write <model>.json + <model>.md under out_dir; returns the paths."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jpath = out / f"{payload['model']}.json"
    jpath.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    mpath = out / f"{payload['model']}.md"
    mpath.write_text(markdown_table(payload))
    return jpath, mpath


def load_report(path: pathlib.Path | str) -> dict:
    """Load a report JSON, rejecting version mismatches loudly."""
    path = pathlib.Path(path)
    payload = json.loads(path.read_text())
    got = payload.get("version")
    if got != REPORT_VERSION:
        raise ValueError(
            f"{path}: report version {got!r} != {REPORT_VERSION}; "
            f"regenerate it (python -m repro_torch.sweep <config> then "
            f"--analyze)"
        )
    return payload
