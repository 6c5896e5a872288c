"""Deterministic grid expansion + per-point feasibility validation.

:func:`expand` turns a :class:`~repro_torch.sweep.config.SweepConfig`
into an ordered list of :class:`GridPoint`: the cartesian product of
the axes, iterated with axis names sorted and values in the order the
config lists them. The enumeration *index* orders execution and the
final ``points.jsonl``; the *point_id* — a short SHA-256 over
``config_hash + canonical point values`` — names the point in the
resume log, so a completed point is recognised across restarts (and a
changed config changes every ID, which is what forces a fresh run).

:func:`validate_point` is the ``--dry-run`` core: it checks the
physics/feasibility bounds a point must satisfy *without executing the
measure* — sub-Vt supplies via
:func:`repro_torch.core.energy.validate_vdd`, CIM grid feasibility via
:class:`~repro_torch.core.params.CIMConfig` +
:func:`repro_torch.core.adc.reference_patterns`, launch cells via
:func:`repro_torch.launch.dryrun.validate_cell` — and returns the
rejection reason (or ``None``). The runner records rejected points as
``status="skipped"`` with that reason, so an infeasible grid corner is
an *artifact*, not a crash.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping

from repro_torch.sweep.config import SweepConfig

# Axis names validate_point knows how to bound-check. Everything else
# is opaque to the planner and validated (if at all) by the measure.
CIM_AXES = ("adc_bits", "rows_active", "coarse_bits", "cutoff")


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One cell of the expanded grid."""

    index: int
    point_id: str
    values: Mapping[str, Any]

    def canonical(self) -> dict:
        def listify(v):
            return [listify(x) for x in v] if isinstance(v, tuple) else v

        return {k: listify(self.values[k]) for k in sorted(self.values)}


def point_id(config_hash: str, values: Mapping[str, Any]) -> str:
    def listify(v):
        return [listify(x) for x in v] if isinstance(v, tuple) else v

    blob = json.dumps(
        {k: listify(values[k]) for k in sorted(values)},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256((config_hash + blob).encode()).hexdigest()[:12]


def expand(config: SweepConfig) -> list[GridPoint]:
    """The ordered grid: product over sorted axis names, stable IDs."""
    import itertools

    names = sorted(config.axes)
    h = config.config_hash
    points = []
    for i, combo in enumerate(
        itertools.product(*(config.axes[n] for n in names))
    ):
        values = dict(zip(names, combo, strict=True))
        points.append(
            GridPoint(index=i, point_id=point_id(h, values), values=values)
        )
    return points


# ---------------------------------------------------------------------------
# Dry-run feasibility
# ---------------------------------------------------------------------------


def _cim_reason(values: Mapping[str, Any]) -> str | None:
    """CIMConfig + ADC reference feasibility for CIM-grid axes."""
    if not any(k in values for k in CIM_AXES):
        return None
    from repro_torch.core import adc
    from repro_torch.core.params import CIMConfig, PAPER_OP_16ROWS

    base = PAPER_OP_16ROWS
    kw = {}
    for k in CIM_AXES:
        if k in values:
            kw["adc_coarse_bits" if k == "coarse_bits" else k] = values[k]
    if "rows_active" in kw:
        kw.setdefault("rows_per_group", max(kw["rows_active"],
                                            base.rows_per_group))
    try:
        cfg = dataclasses.replace(base, **kw)
        adc.reference_patterns(cfg)
    except (ValueError, TypeError) as e:
        return str(e)
    return None


def validate_point(config: SweepConfig, point: GridPoint) -> str | None:
    """The reason this point is infeasible, or None when it can run.

    Pure bound-checking — never executes the measure or compiles
    anything. Unknown axes pass; the measure may still reject them at
    run time (recorded as a skip, same as here).
    """
    values = point.values

    if "vdd" in values:
        from repro_torch.core import energy

        try:
            energy.validate_vdd(float(values["vdd"]))
        except ValueError as e:
            return str(e)

    reason = _cim_reason(values)
    if reason is not None:
        return reason

    if "variant" in values:
        from repro_torch.core import variants as variants_lib

        if values["variant"] not in variants_lib.names():
            return (
                f"unknown variant {values['variant']!r}; registered: "
                f"{sorted(variants_lib.names())}"
            )

    if "backend" in values and "variant" in values:
        from repro_torch.kernels import dispatch

        if values["backend"] not in dispatch.backends_for(values["variant"]):
            return (
                f"backend {values['backend']!r} not registered for "
                f"variant {values['variant']!r}"
            )

    # A string "shape" names a launch cell; a [m, k, n] list is a
    # kernel tuning cell, bound-checked by the autotune measure itself.
    shape = values.get("shape")
    shape_name = shape if isinstance(shape, str) else None
    if "arch" in values or shape_name is not None:
        from repro_torch.launch import dryrun

        try:
            dryrun.validate_cell(values.get("arch"), shape_name)
        except (KeyError, ValueError) as e:
            return str(e)

    return None
