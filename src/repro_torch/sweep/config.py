"""Declarative sweep-config schema (JSON or python dict).

A sweep config names *what* to measure (a registered measure or a
``module:attr`` path), the grid *axes* to expand, constant *params*
the measure reads, and where artifacts land. The schema is pure data —
loading a config touches neither torch nor the measure
implementations, so ``--dry-run`` and the planner stay import-light.
The schema, the canonical form and the hash are the JAX package's
(``repro.sweep.config``): one config has one ``config_hash`` and the
same point IDs in both packages.

Identity: :meth:`SweepConfig.config_hash` is a short SHA-256 of the
*canonical* config (sorted keys, axis values as lists, ``out_dir``
excluded — where results are written is not part of what was swept).
Every artifact the runner and the analysis pass write is stamped with
this hash plus ``SWEEP_VERSION``, and the loaders reject mismatches:
identical configs always produce byte-identical ``points.jsonl``
files, and a results dir can never silently mix two configs.

File formats:

* ``.json`` — an object with the fields below.
* ``.py``   — a module defining ``CONFIG`` (a dict) or ``get_config()``
  returning one, for grids that want python expressiveness.

Fields::

    {
      "name":     "pareto_smoke",          // required; names the sweep
      "measure":  "pareto-smoke",          // registry name or "module:attr"
      "axes":     {"variant": [...], "vdd": [0.6, 0.9]},  // required
      "params":   {"seed": 0},             // measure constants (optional)
      "model":    "smoke2",                // report label (default: name)
      "analysis": "pareto",                // renderer (default: "table")
      "out_dir":  "build/sweeps/..."       // default build/sweeps/<name>
    }

The default output directory is ``build/sweeps/<name>``, not the JAX
package's ``results/sweeps/<name>``: the committed logs there carry the
same config hashes, so a run of this package that resumed from one
would skip every point and report the JAX package's CPU measurements as
its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Any, Mapping

SWEEP_VERSION = 1

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

_FIELDS = ("name", "measure", "axes", "params", "model", "analysis",
           "out_dir")


def _check_scalar(v: Any, where: str) -> None:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return
    if isinstance(v, (list, tuple)):
        for item in v:
            _check_scalar(item, where)
        return
    if isinstance(v, Mapping):
        for item in v.values():
            _check_scalar(item, where)
        return
    raise ValueError(
        f"{where}: value {v!r} is not JSON data (str/num/bool/list/dict)"
    )


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One declarative sweep: measure + grid axes + constants + output."""

    name: str
    measure: str
    axes: Mapping[str, tuple]
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    model: str = ""
    analysis: str = "table"
    out_dir: str | None = None

    def __post_init__(self) -> None:
        if not self.name or not str(self.name).strip():
            raise ValueError("sweep config needs a non-empty 'name'")
        if not self.measure:
            raise ValueError(f"{self.name}: config needs a 'measure'")
        if not self.axes:
            raise ValueError(f"{self.name}: config needs non-empty 'axes'")
        axes = {}
        for k, vals in dict(self.axes).items():
            if not isinstance(vals, (list, tuple)) or len(vals) == 0:
                raise ValueError(
                    f"{self.name}: axis {k!r} must be a non-empty list "
                    f"(got {vals!r})"
                )
            _check_scalar(vals, f"{self.name}: axis {k!r}")
            axes[str(k)] = tuple(
                tuple(v) if isinstance(v, list) else v for v in vals
            )
        object.__setattr__(self, "axes", axes)
        _check_scalar(
            json.loads(json.dumps(dict(self.params))) if self.params else [],
            f"{self.name}: params",
        )
        object.__setattr__(self, "params", dict(self.params))
        if not self.model:
            object.__setattr__(self, "model", self.name)

    # -- identity ----------------------------------------------------------

    def canonical(self) -> dict:
        """The hashed form: sorted keys, lists, no output location."""

        def listify(v):
            return [listify(x) for x in v] if isinstance(v, tuple) else v

        return {
            "name": self.name,
            "measure": self.measure,
            "axes": {k: listify(v) for k, v in sorted(self.axes.items())},
            "params": {k: self.params[k] for k in sorted(self.params)},
            "model": self.model,
            "analysis": self.analysis,
            "version": SWEEP_VERSION,
        }

    @property
    def config_hash(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    # -- locations ---------------------------------------------------------

    @property
    def sweep_dir(self) -> pathlib.Path:
        """Where artifacts land: ``out_dir`` or build/sweeps/<name>.

        A relative ``out_dir`` resolves against the repo root, so
        committed configs mean the same place from any cwd (the CLI
        resolves ``--out`` against the invoking cwd before it gets
        here).
        """
        if self.out_dir:
            p = pathlib.Path(self.out_dir)
            return p if p.is_absolute() else REPO_ROOT / p
        return REPO_ROOT / "build" / "sweeps" / self.name

    @property
    def points_path(self) -> pathlib.Path:
        return self.sweep_dir / "points.jsonl"

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepConfig":
        unknown = sorted(set(d) - set(_FIELDS))
        if unknown:
            raise ValueError(
                f"unknown sweep config field(s) {unknown}; "
                f"known: {list(_FIELDS)}"
            )
        return cls(**{k: d[k] for k in _FIELDS if k in d})

    def to_dict(self) -> dict:
        out = self.canonical()
        del out["version"]
        if self.out_dir:
            out["out_dir"] = self.out_dir
        return out

    def override(
        self,
        *,
        axes: Mapping[str, Any] | None = None,
        params: Mapping[str, Any] | None = None,
        out_dir: str | pathlib.Path | None = None,
    ) -> "SweepConfig":
        """A copy with axes/params merged in (new hash, new identity)."""
        d = self.to_dict()
        if axes:
            d["axes"] = {**d["axes"], **{k: list(v) for k, v in axes.items()}}
        if params:
            d["params"] = {**d["params"], **dict(params)}
        if out_dir is not None:
            d["out_dir"] = str(out_dir)
        return SweepConfig.from_dict(d)


def load_config(path: str | pathlib.Path) -> SweepConfig:
    """Load a sweep config from a ``.json`` or ``.py`` file."""
    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(f"sweep config not found: {path}")
    if path.suffix == ".py":
        ns: dict[str, Any] = {"__file__": str(path)}
        exec(compile(path.read_text(), str(path), "exec"), ns)  # noqa: S102
        if "get_config" in ns:
            raw = ns["get_config"]()
        elif "CONFIG" in ns:
            raw = ns["CONFIG"]
        else:
            raise ValueError(
                f"{path}: a .py sweep config must define CONFIG or "
                f"get_config()"
            )
    else:
        try:
            raw = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: invalid JSON: {e}") from None
    if not isinstance(raw, Mapping):
        raise ValueError(f"{path}: config must be a JSON object/dict")
    return SweepConfig.from_dict(raw)
