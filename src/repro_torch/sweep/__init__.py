"""repro_torch.sweep — config-driven, resumable experiment sweeps.

The declarative harness the repo's studies run through: a JSON/py
config names a measure, grid axes and an output dir; the planner
expands it into stable-ID grid points; the runner executes them
resumably (append-only ``points.jsonl``, completed points skipped on
restart, optional process parallelism) and the analysis pass renders
the log into pareto/summary/tuning-cache reports. It is the JAX
package's harness (``repro.sweep``) on this package's measures: the
committed study configs in ``configs/sweeps/`` run unchanged, on the
card unless their ``params.device`` says ``"cpu"``, into
``build/sweeps/<name>`` unless ``out_dir`` or ``--out`` says otherwise.

Layering: ``config`` is import-light (no torch); measures import their
dependencies lazily at execution time.
"""

from repro_torch.sweep.analysis import analyze
from repro_torch.sweep.config import SWEEP_VERSION, SweepConfig, load_config
from repro_torch.sweep.measures import Measure, SkipPoint
from repro_torch.sweep.plan import GridPoint, expand, validate_point
from repro_torch.sweep.runner import RunReport, dry_run, read_points, run

__all__ = [
    "SWEEP_VERSION",
    "SweepConfig",
    "load_config",
    "GridPoint",
    "expand",
    "validate_point",
    "Measure",
    "SkipPoint",
    "RunReport",
    "dry_run",
    "read_points",
    "run",
    "analyze",
]
