"""The measure registry: what a sweep executes at each grid point.

A *measure* is a function ``(config, point) -> dict`` returning the
JSON record for one grid point (the runner stamps identity fields and
appends it to ``points.jsonl``). Configs name measures either by
registry name (the built-ins below) or as a ``module:attr`` path to
any callable — so a new study is a function plus a JSON file, not a
new script.

Conventions:

* Raise :class:`SkipPoint` for a point that is infeasible at run time;
  the runner records ``status="skipped"`` with the reason (the same
  shape ``--dry-run`` pre-records). Any other exception aborts: a
  kernel that fails to build or launch ends the run.
* The device is ``params["device"]``, default ``"cuda"``; a sweep that
  asks for the card and finds none fails. Pass ``"cpu"`` to run the
  kernels' plain versions.
* Heavy setup (loading the baseline, running a calibration sweep) is
  memoized per process keyed on the config, so grid points share it —
  including inside each worker of a ``--jobs N`` run.
* Records must be deterministic for resume byte-identity: round
  floats, no timestamps. (Exception: timing measures like
  ``autotune`` are deterministic only given a deterministic clock;
  their resume semantics still hold — completed points are never
  re-timed.)

Built-ins::

    grid-echo    pure echo of the point (CI / harness tests)
    pareto       (variant, vdd) -> TOPS/W + accuracy via
                 CalibrationResult.project; params.setup picks the
                 "smoke" 2-layer synthetic or the "resnet" study
    cim-accuracy ResNet top-1 at one (rows_active, adc_bits, cutoff,
                 noisy) CIM operating point (the Fig. 7 axes)
    autotune     kernels.autotune.sweep_shape winner per
                 (variant, shape) — renders back to the tuning cache
                 via the "autotune" analysis

    dryrun-cell  launch.dryrun.run_cell per (arch, shape): the cell
                 built on meta tensors against the production mesh
                 (per-device bytes, FLOPs; no compile)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Mapping

from repro_torch.sweep.config import SweepConfig
from repro_torch.sweep.plan import GridPoint


class SkipPoint(Exception):
    """Raised by a measure for a run-time-infeasible point."""


MeasureFn = Callable[[SweepConfig, GridPoint], Mapping[str, Any]]
ValidateFn = Callable[[SweepConfig, GridPoint], "str | None"]


@dataclasses.dataclass(frozen=True)
class Measure:
    name: str
    fn: MeasureFn
    # Extra dry-run validation beyond plan.validate_point (axis
    # presence, shape well-formedness); returns a reason or None.
    validate: ValidateFn | None = None


_REGISTRY: dict[str, Measure] = {}


def register(
    name: str, fn: MeasureFn, *, validate: ValidateFn | None = None
) -> Measure:
    m = Measure(name=name, fn=fn, validate=validate)
    _REGISTRY[name] = m
    return m


def registered() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve(name: str) -> Measure:
    """A registered measure, or an imported ``module:attr`` callable."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if ":" in name:
        import importlib

        mod_name, attr = name.split(":", 1)
        try:
            obj = getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError) as e:
            raise ValueError(f"cannot import measure {name!r}: {e}") from None
        if isinstance(obj, Measure):
            return obj
        if callable(obj):
            return Measure(name=name, fn=obj)
        raise ValueError(f"measure {name!r} is not callable")
    raise ValueError(
        f"unknown measure {name!r}; registered: {list(registered())} "
        f"(or use a 'module:attr' import path)"
    )


def _round(x, nd: int = 6):
    return None if x is None else round(float(x), nd)


def _params_key(config: SweepConfig) -> str:
    """Cache key for per-process setup: params + the axes it reads."""
    return json.dumps(
        {"params": config.canonical()["params"],
         "axes": config.canonical()["axes"]},
        sort_keys=True, separators=(",", ":"),
    )


def measure_device(config: SweepConfig):
    """``params["device"]`` as a torch.device (default the card); asking
    for the card without one raises."""
    from repro_torch.device import resolve

    return resolve(str(config.params.get("device", "cuda")))


# ---------------------------------------------------------------------------
# grid-echo — pure, instant; what the harness tests and CI dry paths use
# ---------------------------------------------------------------------------


def _grid_echo(config: SweepConfig, point: GridPoint) -> dict:
    # A stable pseudo-metric derived from the point identity, so the
    # analysis pass has a numeric column to summarise.
    value = int(point.point_id[:8], 16) / float(16 ** 8)
    return {"echo": point.canonical(), "value": round(value, 6)}


register("grid-echo", _grid_echo)


# ---------------------------------------------------------------------------
# pareto — (variant, vdd) grid points through CalibrationResult.project
# ---------------------------------------------------------------------------

# The tiny synthetic calibration grid the smoke pareto study sweeps.
SMOKE_GRID_KW = dict(
    adc_bits=(3, 4),
    rows_active=(8, 16),
    coarse_bits=(1,),
    cutoff=(0.5,),
)


def stub_eval_fn(scale: float = 2.0):
    """Deterministic accuracy stub from the fidelity proxy.

    Maps the mean selected rel-L2 of a candidate plan to a pseudo
    top-1 in [0, 1] — monotone in fidelity, cheap, and a pure function
    of the plan, so smoke reports are byte-identical across re-runs.
    """
    import numpy as np

    def eval_fn(result) -> float:
        score = float(np.mean([lc.score for lc in result.layers.values()]))
        return round(max(0.0, 1.0 - scale * score), 6)

    return eval_fn


def smoke_calibration(
    seed: int = 0,
    *,
    variants=("p8t", "adder-tree", "cell-adc"),
    vdd=(0.6, 0.9),
    device="cuda",
):
    """A tiny 2-layer synthetic model calibrated on the smoke grid, on
    ``device`` (the layers are the JAX package's, from the same numpy
    seed)."""
    import numpy as np
    import torch

    from repro_torch.core import calibrate as cal
    from repro_torch.core.pipeline import default_pipeline

    rng = np.random.default_rng(seed)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    weights = {
        "l1": tensor(rng.normal(size=(32, 8)) * 0.1),
        "l2": tensor(rng.normal(size=(16, 8)) * 0.1),
    }
    acts = {
        k: tensor(np.maximum(rng.normal(size=(32, w.shape[0])), 0))
        for k, w in weights.items()
    }
    grid = cal.CalibrationGrid(
        variants=tuple(variants), vdd=tuple(vdd), **SMOKE_GRID_KW
    )
    return cal.calibrate(
        default_pipeline(), weights, acts, grid,
        n_noise_keys=2, seed=seed,
    )


_PARETO_SETUP: dict[str, tuple] = {}


def _pareto_setup(config: SweepConfig):
    """(seed_result, refined_result, eval_fn), memoized per process.

    The "resnet" setup evaluates under hardware noise from one
    generator (``eval_seed``), as the JAX package's does from one key;
    ``params.noisy = false`` evaluates noiselessly, through each
    variant's kernel on the card.
    """
    key = _params_key(config)
    if key in _PARETO_SETUP:
        return _PARETO_SETUP[key]

    import torch

    from repro_torch.core import calibrate as cal

    p = dict(config.params)
    setup = p.get("setup", "smoke")
    variants = tuple(config.axes.get("variant", ("p8t",)))
    vdds = tuple(float(v) for v in config.axes.get("vdd", (0.9,)))
    budget = int(p.get("budget", 0))
    device = measure_device(config)

    if setup == "smoke":
        result = smoke_calibration(
            int(p.get("seed", 0)), variants=variants, vdd=vdds,
            device=device,
        )
        eval_fn = stub_eval_fn(float(p.get("scale", 2.0)))
        refined = (
            cal.refine(result, eval_fn, budget,
                       tol=float(p.get("tol", 0.05)))
            if budget else result
        )
    elif setup == "resnet":
        from repro_torch.configs import resnet as rcfg

        params, bn = _resnet_baseline(device)
        ds = rcfg.dataset()
        noisy = bool(p.get("noisy", True))
        cfg = dataclasses.replace(rcfg.RESNET_CFG,
                                  cim=rcfg.cim_policy(noisy=noisy))
        n_cal = int(p.get("n_cal", 64))
        images = torch.from_numpy(
            ds.batch(n_cal, step=0, train=False)["image"]).to(device)
        grid = cal.CalibrationGrid(
            adc_bits=tuple(p.get("adc_bits", (3, 4, 5))),
            rows_active=tuple(p.get("rows_active", (16,))),
            coarse_bits=tuple(p.get("coarse_bits", (1,))),
            variants=variants,
            vdd=vdds,
        )
        result = cal.calibrate_resnet(
            params, bn, images, cfg, grid=grid,
            max_samples=int(p.get("max_samples", 64)),
        )
        held = ds.batch(int(p.get("n_held", 16)), step=7, train=False)
        generator = None
        if noisy:
            generator = torch.Generator(device=device).manual_seed(
                int(p.get("eval_seed", 1)))
        eval_fn = cal.resnet_eval_fn(
            params, bn, torch.from_numpy(held["image"]).to(device),
            torch.from_numpy(held["label"]).long().to(device), cfg,
            generator=generator,
        )
        refined = (
            cal.refine(result, eval_fn, budget,
                       tol=float(p.get("tol", 0.01)))
            if budget else result
        )
    else:
        raise ValueError(
            f"{config.name}: unknown pareto setup {setup!r} "
            f"(expected 'smoke' or 'resnet')"
        )
    out = (result, refined, cal._memoized_eval(eval_fn))
    _PARETO_SETUP[key] = out
    return out


def _pareto_point(config: SweepConfig, point: GridPoint) -> dict:
    import numpy as np

    _, refined, ev = _pareto_setup(config)
    variant = point.values["variant"]
    vdd = float(point.values["vdd"])
    proj = refined.project(variant, vdd=vdd)
    if proj is None:
        raise SkipPoint(
            f"variant {variant!r} has no scored point for some layer"
        )
    score = float(np.mean([lc.score for lc in proj.layers.values()]))
    grid = dataclasses.asdict(refined.grid)
    return {
        "variant": variant,
        "vdd": _round(vdd),
        "tops_per_w": _round(proj.effective_tops_per_w(), 4),
        "score": _round(score),
        "accuracy": _round(ev(proj)),
        "cost_unit": proj.cost_unit,
        "slack": _round(proj.slack),
        "grid": {k: list(v) for k, v in sorted(grid.items())},
    }


def _pareto_validate(config: SweepConfig, point: GridPoint) -> str | None:
    missing = [a for a in ("variant", "vdd") if a not in point.values]
    if missing:
        return f"pareto measure needs axes {missing} (got " \
               f"{sorted(point.values)})"
    return None


register("pareto", _pareto_point, validate=_pareto_validate)


# ---------------------------------------------------------------------------
# cim-accuracy — ResNet top-1 per CIM operating point (Fig. 7 axes)
# ---------------------------------------------------------------------------

_RESNET_BASELINE: dict[str, tuple] = {}


def _resnet_baseline(device) -> tuple[dict, dict]:
    """The baseline on ``device``, loaded (or trained when no checkpoint
    exists, as the JAX package's studies do) once per process."""
    from repro_torch.configs import resnet as rcfg

    if str(device) not in _RESNET_BASELINE:
        _RESNET_BASELINE[str(device)] = rcfg.train_resnet_baseline(
            device=device)
    return _RESNET_BASELINE[str(device)]


def _batch_seed(seed: int, step: int) -> int:
    """The noise generator's seed of evaluation batch ``step``."""
    import numpy as np

    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


def evaluate(
    params, bn, policy, *, n_images: int = 256, batch: int = 64,
    seed: int = 0, device="cuda",
) -> float:
    """Top-1 of the checkpoint under a CIM execution policy.

    CIM-mode policies evaluate through weight-stationary plans
    (``resnet.plan_params``), planned as the calibrated evaluations
    plan (``calibrate._plan_mode``): on the card without bit planes, so
    a noiseless forward takes each conv through the variant's kernel.
    A noisy policy draws each batch's hardware errors from a generator
    seeded by :func:`_batch_seed`.
    """
    import torch

    from repro_torch.configs import resnet as rcfg
    from repro_torch.core import calibrate as cal
    from repro_torch.models import resnet

    device = torch.device(device)
    cfg = dataclasses.replace(rcfg.RESNET_CFG, cim=policy)
    if policy.mode != "fp":
        params = resnet.plan_params(params, dataclasses.replace(
            policy, mode=cal._plan_mode(device)))
    ds = rcfg.dataset()
    correct = total = 0
    for s in range(n_images // batch):
        b = ds.batch(batch, step=s, train=False)
        generator = None
        if policy.cim.noisy:
            generator = torch.Generator(device=device).manual_seed(
                _batch_seed(seed, s))
        with torch.no_grad():
            logits, _ = resnet.forward(
                params, bn, torch.from_numpy(b["image"]).to(device), cfg,
                train=False, generator=generator)
        pred = torch.argmax(logits, -1).cpu().numpy()
        correct += int((pred == b["label"]).sum())
        total += batch
    return correct / total


def _cim_accuracy(config: SweepConfig, point: GridPoint) -> dict:
    from repro_torch.configs import resnet as rcfg

    device = measure_device(config)
    params, bn = _resnet_baseline(device)
    v = point.values
    p = dict(config.params)
    rows = int(v.get("rows_active", 16))
    bits = int(v.get("adc_bits", 4))
    cutoff = float(v.get("cutoff", 0.5))
    noisy = bool(v.get("noisy", True))
    pol = rcfg.cim_policy(rows=rows, adc_bits=bits, cutoff=cutoff,
                          noisy=noisy)
    acc = evaluate(
        params, bn, pol, n_images=int(p.get("n_images", 128)),
        device=device,
    )
    return {
        "rows_active": rows,
        "adc_bits": bits,
        "cutoff": _round(cutoff),
        "noisy": noisy,
        "accuracy": _round(acc),
    }


register("cim-accuracy", _cim_accuracy)


# ---------------------------------------------------------------------------
# autotune — kernel-winner timing per (variant, shape)
# ---------------------------------------------------------------------------


def _autotune_point(config: SweepConfig, point: GridPoint) -> dict:
    from repro_torch.kernels import autotune, dispatch

    variant = point.values["variant"]
    m, k, n = (int(d) for d in point.values["shape"])
    p = dict(config.params)
    try:
        w = autotune.sweep_shape(
            variant, None, m, k, n,
            reps=int(p.get("reps", 3)), seed=int(p.get("seed", 0)),
            device=measure_device(config),
        )
    except autotune.NoFeasibleCandidate as e:
        raise SkipPoint(str(e)) from None
    cell = dispatch.shape_cell(m, k, n)
    return {
        "variant": variant,
        "shape": [m, k, n],
        "cell": list(cell),
        "backend": w.backend,
        "block": list(w.block) if w.block else None,
        "us": round(float(w.us), 3),
    }


def _autotune_validate(config: SweepConfig, point: GridPoint) -> str | None:
    if "shape" not in point.values or "variant" not in point.values:
        return "autotune measure needs 'variant' and 'shape' axes"
    shape = point.values["shape"]
    if (not isinstance(shape, (list, tuple)) or len(shape) != 3
            or any(int(d) <= 0 for d in shape)):
        return f"shape must be [m, k, n] of positive ints, got {shape!r}"
    return None


register("autotune", _autotune_point, validate=_autotune_validate)


# ---------------------------------------------------------------------------
# dryrun-cell — shape-only launch cells per (arch, shape)
# ---------------------------------------------------------------------------


def _dryrun_cell(config: SweepConfig, point: GridPoint) -> dict:
    from repro_torch.launch import dryrun

    p = dict(config.params)
    rec = dryrun.run_cell(
        point.values["arch"], point.values["shape"],
        multi_pod=p.get("mesh", "single") == "multi",
        do_probe=bool(p.get("probe", False)),
    )
    # Wall/build times and tracebacks are non-deterministic; the
    # deliverable is the memory/FLOPs record.
    for key in ("wall_s", "lower_s", "compile_s", "traceback"):
        rec.pop(key, None)
    return rec


def _dryrun_validate(config: SweepConfig, point: GridPoint) -> str | None:
    if "arch" not in point.values or "shape" not in point.values:
        return "dryrun-cell measure needs 'arch' and 'shape' axes"
    return None


register("dryrun-cell", _dryrun_cell, validate=_dryrun_validate)
