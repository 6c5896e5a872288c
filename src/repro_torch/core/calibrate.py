"""Hardware-aware ADC calibration: the paper's Sec. IV sweep as an API.

The paper's claim is that ADC bit-resolution and the number of activated
rows can be decided by hardware-aware system simulation without losing
DNN accuracy. :func:`calibrate` is that loop: given an
:class:`~repro_torch.core.pipeline.AnalogPipeline` and a set of layers
(weights + captured calibration activations), it sweeps a grid over
(adc_bits, rows_active, coarse/fine split, macro variant, cutoff, vdd),
scores every operating point by the macro-vs-exact output error of the
pipeline's own ADC transfer under injected hardware noise, and selects
the cheapest point per layer within a fidelity slack of the best -- the
rule that picks the paper's {16 rows, 4-bit ADC} point.

Phase two, :func:`refine`, moves one layer at a time toward cheaper grid
points and keeps a move only when held-out top-1 accuracy (a real
forward through ``engine.execute`` and ``kernels.dispatch``,
:func:`resnet_eval_fn`) stays within a tolerance of the seed's;
:meth:`CalibrationResult.pareto` reports the accuracy-vs-TOPS/W frontier
across macro variants x supply voltage. A result registers as an engine
backend::

    result = calibrate_resnet(params, bn_state, images, cfg)
    result.register("analog", overwrite=True)
    policy = CIMPolicy(mode="cim-kernel", backend="analog", cim=...)

after which ``engine.execute`` (and so ``models.resnet.forward``) runs
every planned matmul at its layer's calibrated spec, looked up by the
plan's [K, N] shape, through ``kernels.dispatch`` under the layer's
variant: on a CUDA device with a plan that keeps no unpacked planes
that is the variant's hand-written kernel (B1, B2 or B3). The transfer
executed is the one the sweep scored: per-plane variants derive a
pMAC -> code table from their pipeline's ADC stage and replay it through
an explicit lookup (:func:`_lut_matmul_int`) when it differs from the
floor transfer the kernels implement. :func:`save_result` and
:func:`load_result` read and write the reference's JSON.

Noise: where the reference vmaps its scoring over ``n_noise_keys`` PRNG
keys, the port loops over as many ``torch.Generator`` s on the
activations' device, seeded by :func:`_noise_seeds`; every variant at a
grid point sees the same draws, as in the reference. Noiseless sweeps
select what the reference selects, with scores equal to float32
rounding; noisy ones agree with it in distribution.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import logging
import pathlib
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import dac, energy, engine, quant
from repro_torch.core import variants as variants_lib
from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import (
    AnalogPipeline,
    MacroSpec,
    MacroState,
    default_pipeline,
)
from repro_torch.core.quant import bitslice_weights, plane_signs

# Fidelity slack of the selection rule: a grid point is acceptable when
# its error is within SLACK x the best error on this layer's grid
# (relative to the best, because cutoff clipping and hardware noise are
# common to every point). On resnet20-cifar-family layers a 3-bit ADC
# sits at 2.7-4x the per-layer best and 4-bit @ 16 rows within 1.6-1.9x,
# so 2.0 rejects 3 bits and selects the paper's operating point.
DEFAULT_SLACK = 2.0

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CalibrationGrid:
    """The swept operating-point axes (paper Fig. 7b grid + ADC split,
    the macro-family axis, and optional cutoff/vdd axes; empty = the
    base spec's value)."""

    adc_bits: tuple[int, ...] = (3, 4, 5)
    rows_active: tuple[int, ...] = (4, 8, 16)
    coarse_bits: tuple[int, ...] = (1, 2)
    variants: tuple[str, ...] = ("p8t",)
    cutoff: tuple[float, ...] = ()
    vdd: tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class PointResult:
    """One (layer x grid point) evaluation of the sweep."""

    spec: MacroSpec
    score: float  # relative L2 error of macro output vs exact-int output
    cost: float  # cmp-evals/MAC or fJ/MAC (CalibrationResult.cost_unit)
    variant: str = "p8t"
    order: int = 0  # grid enumeration index (deterministic tie-break)

    @property
    def point(self) -> tuple[int, int, int]:
        return (self.spec.adc_bits, self.spec.rows_active,
                self.spec.adc_coarse_bits)


@dataclasses.dataclass(frozen=True)
class LayerCalibration:
    """Selected operating point of one layer (``table``: the sweep's
    points, empty for a loaded result; ``skipped``: infeasible points
    with reasons)."""

    name: str
    k: int
    n: int
    spec: MacroSpec
    score: float
    cost: float
    table: tuple[PointResult, ...]
    variant: str = "p8t"
    skipped: tuple[str, ...] = ()

    @property
    def adc_spec(self):
        """The layer's calibrated ADCSpec (bits / cutoff / split)."""
        return self.spec.adc


@dataclasses.dataclass(frozen=True)
class RefineMove:
    """One attempted greedy move of the accuracy-refinement phase."""

    layer: str
    variant: str
    adc_bits: int
    rows_active: int
    cutoff: float
    vdd: float
    cost_before: float
    cost_after: float
    accuracy: float  # held-out top-1 measured WITH this move applied
    accepted: bool


@dataclasses.dataclass(frozen=True)
class RefineReport:
    """Trace of one refinement run (attached to a refined result)."""

    seed_accuracy: float
    final_accuracy: float
    tol: float
    budget: int
    evals_used: int
    moves: tuple[RefineMove, ...] = ()


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Per-layer operating points selected by the hardware-aware sweep."""

    layers: Mapping[str, LayerCalibration]
    base: MacroSpec
    grid: CalibrationGrid
    slack: float
    # The pipeline the sweep scored against (None for a loaded result:
    # the default pipeline); the registered backend executes its ADC
    # transfer, so scored == executed.
    pipeline: AnalogPipeline | None = None
    cost_unit: str = "cmp-evals/MAC"
    refinement: RefineReport | None = None

    def __post_init__(self) -> None:
        # One-time-warning memo (not a field: eq/hash/replace unaffected).
        self.__dict__["_warned"] = set()

    def _warn_once(self, key: tuple, msg: str) -> None:
        if key not in self.__dict__["_warned"]:
            self.__dict__["_warned"].add(key)
            warnings.warn(msg, stacklevel=3)

    def layer_for(
        self, k: int, n: int, *, strict: bool = False
    ) -> LayerCalibration | None:
        """The calibrated layer with matmul shape [k, n], or None.

        Backends look layers up by weight shape (the only layer identity
        at the matmul boundary). Several calibrated layers of one shape
        with different selections run at the most conservative (highest
        cost) one, with a one-time warning. An unknown shape raises under
        ``strict``, else warns once and returns None (callers fall back
        to ``base``).
        """
        hits = [
            lc for lc in self.layers.values() if (lc.k, lc.n) == (k, n)
        ]
        if not hits:
            if strict:
                raise KeyError(
                    f"no calibrated layer with shape [{k}, {n}]; "
                    f"calibrated shapes: "
                    f"{sorted({(lc.k, lc.n) for lc in self.layers.values()})}"
                )
            self._warn_once(
                ("fallback", k, n),
                f"no calibrated layer with shape [{k}, {n}]: falling "
                f"back to the uncalibrated base spec "
                f"({self.base.adc_bits}-bit ADC, "
                f"{self.base.rows_active} rows). Pass strict=True (or "
                f"calibrate this layer) if that is not intended.",
            )
            return None
        best = max(hits, key=lambda lc: (lc.cost, lc.spec.adc_bits))
        if any(
            (lc.spec, lc.variant) != (best.spec, best.variant)
            for lc in hits
        ):
            self._warn_once(
                ("collision", k, n),
                f"{len(hits)} calibrated layers share shape [{k}, {n}] "
                f"with different operating points "
                f"({sorted(lc.name for lc in hits)}); executing all of "
                f"them at the most conservative one "
                f"('{best.name}': {best.variant}, "
                f"{best.spec.adc_bits}-bit, {best.spec.rows_active} rows).",
            )
        return best

    def spec_for(self, k: int, n: int, *, strict: bool = False) -> MacroSpec:
        """The calibrated spec of the layer with shape [k, n] (``base``
        for an unknown shape unless ``strict``)."""
        lc = self.layer_for(k, n, strict=strict)
        return self.base if lc is None else lc.spec

    def variant_for(self, k: int, n: int, *, strict: bool = False) -> str:
        """The winning macro variant of the layer with shape [k, n]."""
        lc = self.layer_for(k, n, strict=strict)
        return "p8t" if lc is None else lc.variant

    def operating_point(self) -> tuple[int, int]:
        """(adc_bits, rows_active) selected for the majority of layers."""
        counts = collections.Counter(
            (lc.spec.adc_bits, lc.spec.rows_active)
            for lc in self.layers.values()
        )
        return counts.most_common(1)[0][0]

    def register(self, name: str = "analog", *, overwrite: bool = True) -> str:
        """Register this calibration as an engine execution backend: a
        ``CIMPolicy`` with ``backend=name`` then runs every planned
        matmul at its layer's calibrated spec and variant."""
        engine.register_backend(
            name, calibrated_backend(self), overwrite=overwrite
        )
        return name

    def summary(self) -> str:
        lines = [
            f"{'layer':<16} {'KxN':>10} {'variant':>10} {'adc':>4} "
            f"{'rows':>5} {'split':>6} {'cut':>5} {'vdd':>5} "
            f"{'relerr':>8} {'cost':>8} {'TOPS/W':>7}"
        ]
        for lc in self.layers.values():
            s = lc.spec
            topsw = energy.variant_tops_per_w(s.vdd, lc.variant)
            lines.append(
                f"{lc.name:<16} {f'{lc.k}x{lc.n}':>10} {lc.variant:>10} "
                f"{s.adc_bits:>4} {s.rows_active:>5} "
                f"{f'{s.adc_coarse_bits}+{s.adc_bits - s.adc_coarse_bits}':>6} "
                f"{s.cutoff:>5.2f} {s.vdd:>5.2f} "
                f"{lc.score:>8.4f} {lc.cost:>8.3f} {topsw:>7.2f}"
            )
        bits, rows = self.operating_point()
        lines.append(
            f"selected operating point: {bits}-bit ADC, {rows} active rows"
            f" (paper: 4-bit, 16 rows); cost unit: {self.cost_unit}"
        )
        if self.refinement is not None:
            r = self.refinement
            n_acc = sum(m.accepted for m in r.moves)
            lines.append(
                f"accuracy-refined: {n_acc}/{len(r.moves)} moves accepted "
                f"({r.evals_used}/{r.budget} evals), top-1 "
                f"{r.seed_accuracy:.4f} -> {r.final_accuracy:.4f} "
                f"(tol {r.tol})"
            )
        return "\n".join(lines)

    def effective_tops_per_w(self) -> float:
        """Model-level TOPS/W of the per-layer selections: total ops over
        total energy for one input row through every calibrated layer
        (``k*n`` MACs each at its layer's ``energy.op_energy_j``)."""
        total_macs = total_j = 0.0
        for lc in self.layers.values():
            macs = float(lc.k * lc.n)
            total_macs += macs
            total_j += macs * energy.op_energy_j(lc.spec, lc.variant)
        return 2.0 * total_macs / (total_j * 1e12)

    def _with_point(self, name: str, p: PointResult) -> "CalibrationResult":
        """This result with one layer moved to another sweep point."""
        lc = self.layers[name]
        new_lc = dataclasses.replace(
            lc, spec=p.spec, score=p.score, cost=p.cost, variant=p.variant
        )
        layers = dict(self.layers)
        layers[name] = new_lc
        return dataclasses.replace(self, layers=layers, refinement=None)

    def _require_tables(self, what: str) -> None:
        if self.layers and not any(lc.table for lc in self.layers.values()):
            raise ValueError(
                "result has no sweep tables (loaded via load_result?); "
                f"re-run calibrate() — {what} re-selects per variant "
                "from the per-layer grid tables, which are not persisted"
            )

    def project(
        self, variant: str, vdd: float | None = None
    ) -> "CalibrationResult | None":
        """This result re-selected under one (variant, vdd) pin.

        Re-runs the cheapest-within-slack selection over the recorded
        per-layer tables restricted to ``variant`` (slack relative to the
        variant's own per-layer floor) and, with ``vdd``, pins every
        selected spec to that supply with the cost recomputed there (for
        fJ/MAC results). None when some layer has no scored point for
        the variant.
        """
        if vdd is not None:
            energy.validate_vdd(vdd, what="vdd axis point")
        self._require_tables("projection")
        forced: dict[str, PointResult] = {}
        for name, lc in self.layers.items():
            rows = [p for p in lc.table if p.variant == variant]
            if not rows:
                return None
            forced[name] = _select(rows, self.slack)
        layers = {}
        for name, p in forced.items():
            spec_v = p.spec if vdd is None else p.spec.replace(vdd=vdd)
            cost = (energy.op_energy_j(spec_v, variant) * 1e15
                    if self.cost_unit == "fJ/MAC" else p.cost)
            layers[name] = dataclasses.replace(
                self.layers[name], spec=spec_v,
                score=p.score, cost=cost, variant=variant,
            )
        return dataclasses.replace(self, layers=layers, refinement=None)

    def pareto(
        self,
        *,
        eval_fn: "Callable[[CalibrationResult], float] | None" = None,
        vdds: tuple[float, ...] | None = None,
        variants: tuple[str, ...] | None = None,
    ) -> tuple["ParetoPoint", ...]:
        """Accuracy-vs-TOPS/W frontier across macro variants x supply.

        Each (variant, vdd) combination is :meth:`project` ed and its
        :meth:`effective_tops_per_w` computed; ``eval_fn`` (as
        :func:`refine` takes it) measures held-out top-1 per combination,
        else the fidelity proxy (mean selected rel-L2) ranks accuracy.
        Combinations where some layer has no point for the variant are
        dropped. Points come sorted by (variant, vdd), the non-dominated
        ones flagged; evaluations are memoized on the supply-stripped
        plan, so each variant is evaluated once.
        """
        vlist = tuple(variants if variants is not None
                      else self.grid.variants)
        vddlist = tuple(vdds if vdds is not None
                        else (self.grid.vdd or (self.base.vdd,)))
        for v in vddlist:
            energy.validate_vdd(v, what="vdd axis point")
        self._require_tables("the pareto report")
        ev = None if eval_fn is None else _memoized_eval(eval_fn)
        raw: list[tuple[str, float, float, float, float | None]] = []
        for vname in vlist:
            for v in vddlist:
                res_v = self.project(vname, vdd=float(v))
                if res_v is None:
                    break  # no scored point for this variant anywhere
                score = float(np.mean(
                    [lc.score for lc in res_v.layers.values()]
                ))
                acc = None if ev is None else ev(res_v)
                raw.append((vname, float(v),
                            res_v.effective_tops_per_w(), score, acc))
        return mark_frontier(raw)


def mark_frontier(
    raw: "Sequence[tuple[str, float, float, float, float | None]]",
) -> tuple["ParetoPoint", ...]:
    """Flag the non-dominated (accuracy-vs-TOPS/W) points.

    ``raw`` rows are (variant, vdd, tops_per_w, score, accuracy); the
    accuracy axis is held-out top-1 when present, else the negated
    fidelity proxy (lower rel-L2 = better).
    """

    def metric(t):
        return t[4] if t[4] is not None else -t[3]

    out = []
    for t in raw:
        dominated = any(
            metric(q) >= metric(t) and q[2] >= t[2]
            and (metric(q) > metric(t) or q[2] > t[2])
            for q in raw
        )
        out.append(ParetoPoint(
            variant=t[0], vdd=t[1], tops_per_w=t[2], score=t[3],
            accuracy=t[4], frontier=not dominated,
        ))
    return tuple(sorted(out, key=lambda p: (p.variant, p.vdd)))


def _plan_key(result: CalibrationResult) -> tuple:
    """Execution identity of a plan, with the supply stripped: the
    executed transfer and hardware noise are supply-invariant, so plans
    differing only in ``vdd`` give identical outputs and share one
    accuracy evaluation."""
    base_vdd = result.base.vdd
    return tuple(
        (name, lc.spec.replace(vdd=base_vdd), lc.variant)
        for name, lc in sorted(result.layers.items())
    )


def _memoized_eval(eval_fn, counter: list[int] | None = None):
    """Wrap an eval_fn with the supply-invariant plan-key cache."""
    cache: dict[tuple, float] = {}

    def ev(result: CalibrationResult) -> float:
        k = _plan_key(result)
        if k not in cache:
            cache[k] = float(eval_fn(result))
            if counter is not None:
                counter[0] += 1
        return cache[k]

    return ev


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One (variant, vdd) combination of the accuracy-vs-TOPS/W report."""

    variant: str
    vdd: float
    tops_per_w: float  # model-level effective TOPS/W
    score: float  # mean selected per-layer rel-L2 (fidelity proxy)
    accuracy: float | None  # held-out top-1 (None: proxy-only report)
    frontier: bool  # on the non-dominated frontier


def refine(
    result: CalibrationResult,
    eval_fn: Callable[[CalibrationResult], float],
    budget: int,
    *,
    tol: float = 0.005,
) -> CalibrationResult:
    """Greedy end-to-end accuracy refinement of a proxy-selected plan.

    Each round takes, per layer, the cheapest not-yet-rejected sweep
    point strictly cheaper than the layer's current selection, and tries
    the move with the largest cost saving (ties by layer name, then grid
    order). A move is kept iff ``eval_fn(candidate) >= seed accuracy -
    tol``; a rejected point is never retried. The loop stops when
    ``budget`` evaluations (the seed's included; memoized on the
    supply-stripped plan, so vdd-only moves are free) are spent or no
    cheaper candidate remains. Returns the refined result with its
    :class:`RefineReport`; per-layer costs never increase.
    """
    if budget < 1:
        raise ValueError(f"budget={budget} must be >= 1 (the seed eval)")
    if not any(lc.table for lc in result.layers.values()):
        # Checked before the seed eval: without tables there are no moves.
        raise ValueError(
            "result has no sweep tables (loaded via load_result?); "
            "re-run calibrate() — refinement proposes moves from the "
            "per-layer grid tables, which are not persisted"
        )
    n_evals = [0]
    ev = _memoized_eval(eval_fn, n_evals)
    seed_acc = ev(result)
    floor_acc = seed_acc - tol
    current = result
    current_acc = seed_acc
    moves: list[RefineMove] = []
    rejected: set[tuple[str, MacroSpec, str]] = set()
    while n_evals[0] < budget:
        best: tuple[float, str, int, PointResult] | None = None
        for lname in sorted(current.layers):
            lc = current.layers[lname]
            cands = [
                p for p in lc.table
                if p.cost < lc.cost
                and (lname, p.spec, p.variant) not in rejected
            ]
            if not cands:
                continue
            p = min(cands, key=lambda q: (q.cost, q.score, q.order))
            cand = (-(lc.cost - p.cost), lname, p.order, p)
            if best is None or cand[:3] < best[:3]:
                best = cand
        if best is None:
            break  # no layer has a cheaper untried point left
        _, lname, _, p = best
        candidate = current._with_point(lname, p)
        acc = ev(candidate)
        accepted = acc >= floor_acc
        moves.append(RefineMove(
            layer=lname, variant=p.variant,
            adc_bits=p.spec.adc_bits, rows_active=p.spec.rows_active,
            cutoff=p.spec.cutoff, vdd=p.spec.vdd,
            cost_before=current.layers[lname].cost, cost_after=p.cost,
            accuracy=acc, accepted=accepted,
        ))
        if accepted:
            current = candidate
            current_acc = acc
        else:
            rejected.add((lname, p.spec, p.variant))
    report = RefineReport(
        seed_accuracy=seed_acc, final_accuracy=current_acc, tol=tol,
        budget=budget, evals_used=n_evals[0], moves=tuple(moves),
    )
    return dataclasses.replace(current, refinement=report)


def _plan_mode(device: torch.device) -> str:
    """The mode a calibrated evaluation plans under: plans without bit
    planes (the kernels' route) on a CUDA device, the behavioral plans
    (the scan twin's) elsewhere."""
    return "cim-kernel" if device.type == "cuda" else "cim"


def resnet_eval_fn(
    params: dict,
    bn_state: dict,
    images: torch.Tensor,
    labels: torch.Tensor,
    cfg: Any,  # models.resnet.ResNetConfig (duck-typed: no cycle)
    *,
    generator: torch.Generator | None = None,
    name: str = "__calibrate_eval__",
) -> Callable[[CalibrationResult], float]:
    """Build a :func:`refine` / ``pareto`` eval_fn from a held-out batch.

    ``eval_fn(candidate)`` registers the candidate as a throwaway engine
    backend, measures top-1 with a real forward (im2col convs through
    ``engine.execute`` and ``kernels.dispatch`` at each layer's candidate
    point) and removes the backend again. Weights are planned once: on a
    CUDA device without bit planes, so dispatch takes each layer's
    variant kernel (B1, B2 or B3); elsewhere with them, as the
    reference's behavioral plans, for the scan twin. A ``generator``
    (with a noisy ``cfg.cim.cim``) makes the evaluation noisy; its state
    is restored before every evaluation, so each candidate sees the same
    draws, as the reference's fixed key gives.
    """
    from repro_torch.models import resnet  # core must not import models

    policy = dataclasses.replace(cfg.cim, mode=_plan_mode(images.device),
                                 backend=name)
    rcfg = dataclasses.replace(cfg, cim=policy)
    planned = resnet.plan_params(params, policy)
    state = None if generator is None else generator.get_state()

    def eval_fn(result: CalibrationResult) -> float:
        result.register(name)
        try:
            if generator is not None:
                generator.set_state(state)
            return resnet.top1_accuracy(planned, bn_state, images, labels,
                                        rcfg, generator=generator)
        finally:
            engine._BACKENDS.pop(name, None)

    return eval_fn


def adc_code_table(
    pipeline: AnalogPipeline, spec: MacroSpec | CIMConfig
) -> torch.Tensor:
    """pMAC -> code table (int32) derived from the pipeline's ADC stage:
    every pMAC level through the ideal ABL equation and the stage, noise
    off (a pipeline without an "adc" stage reads the floor transfer)."""
    spec = MacroSpec.from_config(spec).replace(noisy=False)
    pmac = torch.arange(spec.pmac_levels, dtype=torch.float32)
    v_abl = dac.abl_voltage_from_pmac(pmac, spec)
    try:
        stage = pipeline.stage("adc")
    except KeyError:
        return adc_lib.adc_transfer_int(pmac, spec)
    state = stage(MacroState(v_abl=v_abl), spec)
    return state.adc_codes.to(torch.int32)


def _grouped_pmac(x_codes: torch.Tensor, planes: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """[M, K] codes x [B, K, N] planes -> [M, G, B, N] group partials
    (exact integers, contracted in float64 on any device)."""
    m, k = x_codes.shape
    b, _, n = planes.shape
    g = -(-k // rows)
    xp = torch.nn.functional.pad(x_codes.to(torch.float64), (0, g * rows - k))
    wp = torch.nn.functional.pad(planes.to(torch.float64),
                                 (0, 0, 0, g * rows - k))
    return torch.einsum("mgr,bgrn->mgbn", xp.reshape(m, g, rows),
                        wp.reshape(b, g, rows, n))


def hw_cost(spec: MacroSpec | CIMConfig) -> float:
    """Comparator evaluations per MAC at this operating point (P-8T):
    ``comparator_count / rows_active``, the P-8T variant's cost model
    (other macro families define their own ``MacroVariant.hw_cost``)."""
    return variants_lib.P8T.hw_cost(spec)


def _noise_seeds(seed: int, salt: int, n: int) -> list[int]:
    """The ``n`` generator seeds of one scored grid point: the first 63
    bits of sha256(f"{seed}:{salt}:{j}") for j = 0..n-1, where ``salt``
    is the reference's per-point fold-in (layer index, rows, ADC bits,
    cutoff index), so every variant at a point sees the same draws."""
    return [int.from_bytes(hashlib.sha256(
        f"{seed}:{salt}:{j}".encode()).digest()[:8], "little") >> 1
        for j in range(n)]


def _noise_draws(shape, seeds: list[int] | None, device):
    """One N(0, 1) draw of ``shape`` per seed (a fresh generator on
    ``device`` each), or a single None for noiseless scoring."""
    if seeds is None:
        yield None
        return
    for sd in seeds:
        g = torch.Generator(device=device).manual_seed(sd)
        yield dac.standard_normal(shape, g, device)


def _macro_scores(
    pmac: torch.Tensor,
    y_ref: torch.Tensor,
    spec: MacroSpec,
    table: torch.Tensor,
    seeds: list[int] | None,
) -> float:
    """Relative L2 error (float32) of the table-driven macro output
    against the exact product, averaged over the noise draws: hardware
    errors enter in the pMAC domain (``sigma_pmac``, the behavioral
    model's fold-in), then round to the nearest level before lookup."""
    signs = plane_signs(spec.weight_bits, pmac.device).to(torch.float32)
    levels = spec.pmac_levels
    step = spec.adc_step
    sigma = spec.replace(noisy=True).sigma_pmac
    ref_norm = torch.linalg.norm(y_ref) + 1e-12
    x0 = pmac.to(torch.float32)
    errs = []
    for z in _noise_draws(x0.shape, seeds, x0.device):
        x = x0 if z is None else x0 + sigma * z
        idx = torch.clamp(torch.round(x), 0, levels - 1).long()
        deq = table[idx].to(torch.float32) * step
        y = torch.einsum("mgbn,b->mn", deq, signs)
        errs.append(torch.linalg.norm(y - y_ref) / ref_norm)
    return float(torch.mean(torch.stack(errs)))


def _merged_pmac(pmac: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """[M, G, B, N] plane partials -> [M, G, N] signed merged values."""
    signs = plane_signs(weight_bits, pmac.device).to(torch.float32)
    return torch.einsum("mgbn,b->mgn", pmac.to(torch.float32), signs)


def _merged_scores(
    merged: torch.Tensor,
    sigma: float,
    y_ref: torch.Tensor,
    spec: MacroSpec,
    seeds: list[int] | None,
) -> float:
    """Relative L2 error of the single-ADC merged transfer against the
    exact product: noise in the merged domain, then the transfer
    ``variants.merged_transfer_int`` executes (scored == replayed)."""
    ref_norm = torch.linalg.norm(y_ref) + 1e-12
    errs = []
    for z in _noise_draws(merged.shape, seeds, merged.device):
        x = merged if z is None else merged + sigma * z
        code = variants_lib.merged_transfer_int(x, spec)
        y = torch.sum(variants_lib.merged_dequant(code, spec), dim=1)
        errs.append(torch.linalg.norm(y - y_ref) / ref_norm)
    return float(torch.mean(torch.stack(errs)))


def _layer_codes(w, weight_bits: int) -> torch.Tensor:
    if isinstance(w, engine.PlannedWeights):
        return w.codes_i32
    return quant.quantize_weights(
        torch.as_tensor(w).to(torch.float32), weight_bits).codes


def calibrate(
    pipeline: AnalogPipeline,
    weights: Mapping[str, Any],
    acts: Mapping[str, torch.Tensor] | torch.Tensor,
    grid: CalibrationGrid = CalibrationGrid(),
    *,
    base: MacroSpec | CIMConfig | None = None,
    slack: float = DEFAULT_SLACK,
    noisy: bool = True,
    n_noise_keys: int = 2,
    max_samples: int = 256,
    act_symmetric: bool = True,
    act_clip_pct: float = 1.0,
    seed: int = 0,
) -> CalibrationResult:
    """Sweep the grid per layer and select each layer's operating point.

    Args:
      pipeline: the analog pipeline whose ADC stage defines the ("p8t")
        transfer being calibrated; other variants use their registered
        pipelines.
      weights: name -> [K, N] float weight (or its PlannedWeights).
      acts: name -> [M, K] calibration activations (a layer's matmul
        inputs, e.g. captured by ``models.resnet.forward(tap=...)``); one
        tensor applies to every layer. The sweep runs on their device.
      grid: the swept axes.
      base: operating point carrying the un-swept knobs; default the
        paper's 16-row point.
      slack: a point is feasible when its error is within ``slack`` x
        the best on this layer's grid; the cheapest feasible point wins
        (ties by score, then grid order), else the most accurate.
      noisy: score under injected hardware errors, averaged over
        ``n_noise_keys`` generators (:func:`_noise_seeds`).
      max_samples: activation rows subsampled per layer (numpy
        ``default_rng(seed)``, as the reference).
      act_symmetric / act_clip_pct: the activation quantizer's settings.

    Fidelity is scored once per (rows, cutoff, adc_bits, variant) and
    fanned out over the coarse split and ``vdd`` (supply-invariant); the
    vdd and cutoff axes are validated before the sweep starts, and grid
    points a cutoff makes infeasible are skipped with the reason
    recorded on ``LayerCalibration.skipped``.
    """
    base_spec = MacroSpec.from_config(base) if base is not None \
        else MacroSpec()
    rng = np.random.default_rng(seed)

    # Swept cutoff/vdd axes; empty = inherit the base spec's value. A
    # non-empty vdd axis switches the cost model to energy per MAC.
    cutoffs = tuple(grid.cutoff) or (base_spec.cutoff,)
    vdds = tuple(grid.vdd) or (base_spec.vdd,)
    energy_cost = bool(grid.vdd)
    cost_unit = "fJ/MAC" if energy_cost else "cmp-evals/MAC"
    for c in cutoffs:
        if not (0.0 <= c < 1.0):
            raise ValueError(
                f"cutoff axis point {c} out of range [0, 1)"
            )
    for v in vdds:
        energy.validate_vdd(v, what="vdd axis point")

    # Code tables depend only on (variant, spec), not the layer: derived
    # once on the host, kept per device.
    lut_cache: dict[tuple[str, MacroSpec, str], torch.Tensor] = {}

    def pipe_for(vname: str) -> AnalogPipeline:
        return pipeline if vname == "p8t" else variants_lib.get_pipeline(
            vname)

    def lut_for(vname: str, spec_rb: MacroSpec, device) -> torch.Tensor:
        key = (vname, spec_rb, str(device))
        if key not in lut_cache:
            lut_cache[key] = adc_code_table(pipe_for(vname),
                                            spec_rb).to(device)
        return lut_cache[key]

    layers: dict[str, LayerCalibration] = {}
    for li, (name, w) in enumerate(weights.items()):
        x2 = acts[name] if isinstance(acts, Mapping) else acts
        x2 = torch.as_tensor(x2).to(torch.float32)
        dev = x2.device
        if x2.shape[0] > max_samples:
            sel = rng.choice(x2.shape[0], size=max_samples, replace=False)
            x2 = x2[torch.from_numpy(np.sort(sel)).to(dev)]
        if (isinstance(w, engine.PlannedWeights)
                and w.weight_bits != base_spec.weight_bits):
            raise ValueError(
                f"{name}: plan weight_bits={w.weight_bits} != base spec "
                f"weight_bits={base_spec.weight_bits}"
            )
        w_codes = _layer_codes(w, base_spec.weight_bits).to(dev)
        k, n = w_codes.shape
        if x2.shape[1] != k:
            raise ValueError(
                f"{name}: acts K={x2.shape[1]} != weight K={k}"
            )
        qa = quant.quantize_acts(
            x2, base_spec.act_bits,
            symmetric=act_symmetric, clip_pct=act_clip_pct,
        )
        x_codes = qa.codes
        planes = bitslice_weights(w_codes, base_spec.weight_bits)
        # Exact integers: float64 holds every sum, one rounding to f32
        # as the reference's int32 product and cast.
        y_ref = (x_codes.to(torch.float64) @ w_codes.to(torch.float64)
                 ).to(torch.float32)

        table_rows: list[PointResult] = []
        skipped: list[str] = []
        order = 0

        def skip(vname, bits, rows, cut, reason, *, name=name,
                 skipped=skipped):
            msg = (f"variant={vname} adc_bits={bits} rows={rows} "
                   f"cutoff={cut:g}: {reason}")
            logger.info(
                "calibrate: %s: infeasible grid point skipped (%s)",
                name, msg,
            )
            skipped.append(msg)

        for rows in grid.rows_active:
            try:
                spec_row = base_spec.replace(rows_active=rows)
            except ValueError as e:
                skipped.append(f"rows={rows}: {e}")
                continue
            pmac = _grouped_pmac(x_codes, planes, rows)
            merged = sigma_m = None  # built once per row count, on demand
            for ci, cut in enumerate(cutoffs):
                spec_rc = spec_row.replace(cutoff=cut)
                for bits in grid.adc_bits:
                    try:
                        spec_rb = spec_rc.replace(adc_bits=bits,
                                                  adc_coarse_bits=0)
                    except ValueError as e:
                        # bits out of range at this row count
                        skip("*", bits, rows, cut, str(e))
                        continue
                    # Same noise for every variant at this grid point.
                    seeds = None
                    if noisy:
                        seeds = _noise_seeds(
                            seed,
                            li * 1000 + rows * 10 + bits + ci * 1_000_003,
                            n_noise_keys,
                        )
                    for vname in grid.variants:
                        var = variants_lib.get(vname)
                        if var.per_plane_adc:
                            if spec_rb.threshold % spec_rb.adc_codes != 0:
                                skip(vname, bits, rows, cut,
                                     "no integer reference spacing")
                                continue
                            try:
                                lut = lut_for(vname, spec_rb, dev)
                            except ValueError as e:
                                # e.g. a swept cutoff pushed a reference
                                # level beyond the arrays' charge range
                                skip(vname, bits, rows, cut, str(e))
                                continue
                            score = _macro_scores(
                                pmac, y_ref, spec_rb, lut, seeds
                            )
                        else:
                            mq = variants_lib.merged_quant(spec_rb)
                            if mq.step != int(mq.step):
                                skip(vname, bits, rows, cut,
                                     "no integer merged-grid spacing")
                                continue
                            if merged is None:  # bits/cut-independent
                                merged = _merged_pmac(
                                    pmac, base_spec.weight_bits
                                )
                                sigma_m = variants_lib.merged_sigma(
                                    spec_row
                                )
                            score = _merged_scores(
                                merged, sigma_m, y_ref, spec_rb, seeds
                            )
                        splits = (grid.coarse_bits if var.flash_split
                                  else (0,))
                        for c in splits:
                            if not (0 <= c <= bits):
                                continue
                            for v in vdds:
                                spec_full = spec_rb.replace(
                                    adc_coarse_bits=c, vdd=v
                                )
                                if energy_cost:
                                    cost = energy.op_energy_j(
                                        spec_full, vname
                                    ) * 1e15
                                else:
                                    cost = var.hw_cost(spec_full)
                                table_rows.append(PointResult(
                                    spec=spec_full,
                                    score=score,
                                    cost=cost,
                                    variant=vname,
                                    order=order,
                                ))
                                order += 1
        if not table_rows:
            detail = (f" ({len(skipped)} grid points skipped; first: "
                      f"{skipped[0]})" if skipped else "")
            raise ValueError(f"{name}: empty feasible grid{detail}")
        best = _select(table_rows, slack)
        layers[name] = LayerCalibration(
            name=name, k=k, n=n,
            spec=best.spec, score=best.score, cost=best.cost,
            table=tuple(table_rows), variant=best.variant,
            skipped=tuple(skipped),
        )
    return CalibrationResult(
        layers=layers, base=base_spec, grid=grid, slack=slack,
        pipeline=pipeline, cost_unit=cost_unit,
    )


def _select(table_rows: list[PointResult], slack: float) -> PointResult:
    """The cheapest-within-slack rule over one layer's sweep table.

    Ties break totally: feasible points by (cost, score, grid order);
    the nothing-within-slack fallback (possible when ``slack < 1``) by
    (score, cost, grid order).
    """
    floor = min(p.score for p in table_rows)
    feasible = [p for p in table_rows if p.score <= slack * floor]
    if feasible:
        return min(feasible, key=lambda p: (p.cost, p.score, p.order))
    return min(table_rows, key=lambda p: (p.score, p.cost, p.order))


def _planned_pmac(x_codes: torch.Tensor, planes: torch.Tensor,
                  weight_bits: int) -> torch.Tensor:
    """[M, K] codes x plan planes (unpacked [G, B, rows, N] or packed
    [G, rows, N] uint8, grouped at the target rows_active) -> [M, G, B, N]
    partials."""
    m, k = x_codes.shape
    if planes.ndim == 3:  # packed: 8 planes/byte
        planes = bitslice_weights(planes, weight_bits).permute(1, 0, 2, 3)
    g, b, rows, n = planes.shape
    xp = torch.nn.functional.pad(x_codes.to(torch.float64), (0, g * rows - k))
    return torch.einsum("mgr,gbrn->mgbn", xp.reshape(m, g, rows),
                        planes.to(torch.float64))


def _lut_matmul_int(x_codes, w_codes, spec, table, generator,
                    planes=None) -> torch.Tensor:
    """Grouped macro matmul through an explicit ADC code table: the
    transfer the sweep scored, for a pipeline whose ADC differs from the
    floor transfer (noise, with ``spec.noisy`` and a generator, enters in
    the pMAC domain and rounds to the nearest level before the lookup).
    ``planes`` reuses a plan's grouped bit planes (already at
    ``spec.rows_active``)."""
    if planes is None:
        sliced = bitslice_weights(w_codes, spec.weight_bits)
        pmac = _grouped_pmac(x_codes, sliced, spec.rows_active)
    else:
        pmac = _planned_pmac(x_codes, planes, spec.weight_bits)
    x = pmac.to(torch.float32)
    if spec.noisy and generator is not None:
        x = x + spec.sigma_pmac * dac.standard_normal(x.shape, generator,
                                                      x.device)
    idx = torch.clamp(torch.round(x), 0, spec.pmac_levels - 1).long()
    deq = table.to(x.device)[idx].to(torch.float32) * spec.adc_step
    signs = plane_signs(spec.weight_bits, x.device).to(torch.float32)
    return torch.einsum("mgbn,b->mn", deq, signs)


def calibrated_backend(result: CalibrationResult) -> engine.BackendFn:
    """An execution backend running each layer at its calibrated spec.

    The shared quantized epilogue around the macro matmul; the operating
    point and variant are looked up per layer by plan shape:

      * a merged-conversion variant (adder-tree) runs its transfer
        through ``kernels.dispatch``;
      * a per-plane variant (p8t, cell-adc) compares its pipeline's code
        table (at the split-normalized spec the sweep scored) with the
        floor transfer: equal, it runs through ``kernels.dispatch`` under
        the variant's name; different, through that exact table.

    Tables are derived once, here. Hardware noise follows the execution
    policy (``policy.cim.noisy`` with a generator routes to the scan
    twin, or the table path's own draws), not the calibration's base.
    """
    from repro_torch.kernels import dispatch  # dispatch imports engine

    pipe = result.pipeline or default_pipeline()
    reachable = {
        (lc.variant, lc.spec) for lc in result.layers.values()
    } | {("p8t", result.base)}
    table_cache: dict[tuple[str, MacroSpec], tuple[bool, Any]] = {}
    for vname, spec in sorted(reachable, key=repr):
        var = variants_lib.get(vname)
        if not var.per_plane_adc:
            continue  # merged conversions execute via dispatch
        vpipe = pipe if vname == "p8t" else var.pipeline
        scored = spec.replace(adc_coarse_bits=0, noisy=False)
        table = adc_code_table(vpipe, scored)
        pmac = torch.arange(spec.pmac_levels, dtype=torch.float32)
        want = adc_lib.adc_transfer_int(pmac, scored)
        table_cache[(vname, spec)] = (bool(torch.equal(table, want)), table)

    def _int_fn(x_codes, plan, cfg, generator):
        lc = result.layer_for(plan.k, plan.n)
        spec = result.base if lc is None else lc.spec
        vname = "p8t" if lc is None else lc.variant
        if spec.act_bits != cfg.act_bits:
            raise ValueError(
                f"calibrated spec act_bits={spec.act_bits} != policy "
                f"act_bits={cfg.act_bits}"
            )
        if spec.weight_bits != plan.weight_bits:
            raise ValueError(
                f"calibrated spec weight_bits={spec.weight_bits} != plan "
                f"weight_bits={plan.weight_bits}"
            )
        run_spec = spec.replace(noisy=cfg.noisy)
        if variants_lib.get(vname).per_plane_adc:
            is_default, table = table_cache[(vname, spec)]
            if not is_default:
                planes = plan.planes
                if (
                    planes is not None
                    and planes.shape[-2] != spec.rows_active
                ):
                    planes = engine.regroup_planes(
                        planes, plan.k, spec.rows_active
                    )
                return _lut_matmul_int(x_codes, plan.codes_i32, run_spec,
                                       table, generator, planes=planes)
        return dispatch.dispatch(
            x_codes, plan.codes, run_spec,
            variant=vname, generator=generator, planes=plan.planes,
            slots=plan.slots,
        )

    return engine.quantized_backend(_int_fn)


# ---------------------------------------------------------------------------
# Persistence: the reference's JSON format, read and written byte for byte
# ---------------------------------------------------------------------------


def _spec_dict(spec: MacroSpec) -> dict:
    return dataclasses.asdict(spec.to_config())


def result_to_dict(result: CalibrationResult) -> dict:
    """JSON-serializable form of the per-layer selections (sweep tables
    and the scored pipeline are not persisted)."""
    payload: dict = {
        "version": 1,
        "base": _spec_dict(result.base),
        "slack": result.slack,
        "cost_unit": result.cost_unit,
        "grid": dataclasses.asdict(result.grid),
        "layers": {
            name: {
                "k": lc.k,
                "n": lc.n,
                "variant": lc.variant,
                "score": lc.score,
                "cost": lc.cost,
                "spec": _spec_dict(lc.spec),
                "skipped": list(lc.skipped),
            }
            for name, lc in result.layers.items()
        },
    }
    if result.refinement is not None:
        payload["refinement"] = dataclasses.asdict(result.refinement)
    return payload


def result_from_dict(payload: dict) -> CalibrationResult:
    if payload.get("version") != 1:
        raise ValueError(
            f"unsupported calibration payload version "
            f"{payload.get('version')!r}"
        )
    refinement = None
    if "refinement" in payload:
        r = dict(payload["refinement"])
        r["moves"] = tuple(RefineMove(**m) for m in r.get("moves", ()))
        refinement = RefineReport(**r)
    layers = {}
    for name, d in payload["layers"].items():
        layers[name] = LayerCalibration(
            name=name, k=int(d["k"]), n=int(d["n"]),
            spec=MacroSpec.from_config(CIMConfig(**d["spec"])),
            score=float(d["score"]), cost=float(d["cost"]),
            table=(), variant=d["variant"],
            skipped=tuple(d.get("skipped", ())),
        )
    return CalibrationResult(
        layers=layers,
        base=MacroSpec.from_config(CIMConfig(**payload["base"])),
        grid=CalibrationGrid(
            **{k: tuple(v) for k, v in payload["grid"].items()}),
        slack=float(payload["slack"]),
        pipeline=None,
        cost_unit=payload.get("cost_unit", "cmp-evals/MAC"),
        refinement=refinement,
    )


def save_result(result: CalibrationResult, path) -> pathlib.Path:
    """Persist a calibration result as deterministic JSON."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(result_to_dict(result), indent=2, sort_keys=True)
        + "\n"
    )
    return path


def load_result(path) -> CalibrationResult:
    """Load a persisted result (counterpart of :func:`save_result`)."""
    return result_from_dict(json.loads(pathlib.Path(path).read_text()))


@torch.no_grad()
def calibrate_resnet(
    params: dict,
    bn_state: dict,
    images: torch.Tensor,
    cfg: Any,  # models.resnet.ResNetConfig (duck-typed: no cycle)
    grid: CalibrationGrid = CalibrationGrid(),
    *,
    pipeline: AnalogPipeline | None = None,
    **kw,
) -> CalibrationResult:
    """Calibrate every macro-eligible conv of a ResNet (paper Sec. IV).

    One fp forward with activation taps captures each conv's im2col
    inputs and weight matrix (a strided subset of ``max_samples`` rows
    per layer, spread across images and positions), then :func:`calibrate`
    sweeps the grid on the images' device. The stem and logits follow
    ``cfg.cim``'s exemptions (an exempt stem is not calibrated).
    """
    from repro_torch.models import resnet  # core must not import models

    taps: dict[str, tuple[torch.Tensor, Any]] = {}
    cap = max(int(kw.get("max_samples", 256)), 1)

    def tap(name, x2, w):
        if name not in taps:
            stride = max(1, x2.shape[0] // cap)
            taps[name] = (x2[::stride][:cap], w)

    fp_cfg = dataclasses.replace(
        cfg, cim=dataclasses.replace(cfg.cim, mode="fp")
    )
    resnet.forward(params, bn_state, images, fp_cfg, train=False, tap=tap)
    weights = {name: w for name, (_, w) in taps.items()}
    acts = {name: x2 for name, (x2, _) in taps.items()}
    kw.setdefault("act_symmetric", cfg.cim.act_symmetric)
    kw.setdefault("act_clip_pct", cfg.cim.act_clip_pct)
    kw.setdefault("base", MacroSpec.from_config(cfg.cim.cim))
    return calibrate(
        pipeline if pipeline is not None else default_pipeline(),
        weights, acts, grid, **kw,
    )
