"""Per-(arch, variant, shape-cell) kernel autotuning with a JSON cache.

The dispatch heuristics pick a safe default; this module replaces them
with measured winners: :func:`sweep_shape` times every registered backend
(and, for the "cuda" kernels, every column tile they are built for) of
one variant at one representative shape, :func:`autotune` runs the sweep
over a shape/variant grid, and the winners persist to a JSON cache that
``kernels.dispatch`` consults before its heuristics, so a tuned
deployment keeps its per-shape choices across processes without timing
anything at serve time.

The cache lives under ``$REPRO_TORCH_AUTOTUNE_DIR``, else
``build/autotune/`` in the repository (git-ignored), as ``<arch>.json``:
``arch`` names the device, ``cpu`` or the card's compute capability
(``sm90`` on an H100). It is the port's own; the JAX package's
``results/autotune/`` is never read or written here.

Cache file format (version 1)::

    {
      "version": 1,
      "arch": "sm90",
      "sweep_version": 1,
      "entries": {
        "p8t/m4_k1024_n1024": {"backend": "cuda", "block": [64, 16, 16],
                               "us": 217.4, "swept_at": 1},
        "p8t/m8192_k512_n2048": {"backend": "cuda", "block": [64, 64, 16],
                                 "us": 529.1, "swept_at": 1}
      }
    }

Keys are ``<variant>/m<cell>_k<cell>_n<cell>`` over the power-of-two
cells of :func:`dispatch.shape_cell`; ``block`` is the pinned kernel
block (``dispatch.cuda_block``; null for the other backends), of which
dispatch takes only bn and recomputes bm and bk at the call's
rows_active. Entries are written sorted, so the same sweep gives
byte-identical files.

``sweep_version`` is a counter bumped by every merging :func:`autotune`
run, and each entry records the ``swept_at`` version that last measured
it (not a wall-clock stamp, so the files stay deterministic):
:func:`stale_entries` lists the cells a partial re-sweep left behind.

Timing is injectable (``measure=``) so tests pin winners with a
deterministic proxy; the default measures the best of ``reps`` calls,
with CUDA events on the card and the host clock on the CPU. Candidates
infeasible at the shape (a ``ValueError``: a depth guard, an operating
point the kernel does not take, a slots operand the point cannot pack)
are skipped, never winners; any other error, a kernel that fails to
build or launch among them, ends the sweep.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import time
import warnings
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec, as_spec
from repro_torch.kernels import dispatch
from repro_torch.kernels.cim_mac import KERNEL_BNS

CACHE_VERSION = 1

logger = logging.getLogger(__name__)

Block = tuple[int, int, int]
Candidate = tuple[str, Block | None]
# measure(candidate, run) -> seconds for one call; ``run`` executes the
# (already warmed) candidate once, waits for the device, and returns its
# output.
MeasureFn = Callable[[Candidate, Callable[[], torch.Tensor]], float]


def device_arch(device: str | torch.device) -> str:
    """The cache's arch name of a device: ``cpu``, or ``sm<major><minor>``
    of a CUDA card (``sm90`` on an H100)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm{major}{minor}"


def _process_arch() -> str:
    """The arch whose cache dispatch consults in this process: the card's
    where there is one, else the CPU's."""
    return device_arch("cuda" if torch.cuda.is_available() else "cpu")


def default_cache_dir() -> pathlib.Path:
    """``$REPRO_TORCH_AUTOTUNE_DIR``, else build/autotune in the repo."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "autotune"


def cache_path(arch: str) -> pathlib.Path:
    return default_cache_dir() / f"{arch}.json"


@dataclasses.dataclass(frozen=True)
class Winner:
    """The pinned choice for one (variant, shape cell).

    ``swept_at`` is the cache's ``sweep_version`` when this entry was
    last measured (0 = predates versioned sweeps); bookkeeping for
    staleness reports, not read by dispatch.
    """

    backend: str
    block: Block | None
    us: float
    swept_at: int = 0

    def to_json(self) -> dict:
        return {
            "backend": self.backend,
            "block": list(self.block) if self.block else None,
            "us": self.us,
            "swept_at": self.swept_at,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "Winner":
        block = d.get("block")
        return cls(
            backend=d["backend"],
            block=tuple(block) if block else None,
            us=float(d.get("us", 0.0)),
            swept_at=int(d.get("swept_at", 0)),
        )


def cell_id(variant: str, cell: tuple[int, int, int]) -> str:
    return f"{variant}/m{cell[0]}_k{cell[1]}_n{cell[2]}"


@dataclasses.dataclass
class TuningCache:
    """The per-arch winner table, JSON round-trippable.

    ``sweep_version`` counts merging :func:`autotune` runs; entries whose
    ``swept_at`` lags it were inherited from an earlier sweep
    (:func:`stale_entries`).
    """

    arch: str
    entries: dict[str, Winner] = dataclasses.field(default_factory=dict)
    sweep_version: int = 0

    def lookup(
        self, variant: str, cell: tuple[int, int, int]
    ) -> Winner | None:
        return self.entries.get(cell_id(variant, cell))

    def put(
        self, variant: str, cell: tuple[int, int, int], winner: Winner
    ) -> None:
        self.entries[cell_id(variant, cell)] = winner

    def to_json(self) -> dict:
        return {
            "version": CACHE_VERSION,
            "arch": self.arch,
            "sweep_version": self.sweep_version,
            "entries": {
                k: self.entries[k].to_json() for k in sorted(self.entries)
            },
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "TuningCache":
        if d.get("version") != CACHE_VERSION:
            raise ValueError(
                f"tuning cache version {d.get('version')} != "
                f"{CACHE_VERSION}; re-run kernels.autotune.autotune"
            )
        return cls(
            arch=d.get("arch", "unknown"),
            entries={
                k: Winner.from_json(v) for k, v in d["entries"].items()
            },
            sweep_version=int(d.get("sweep_version", 0)),
        )

    def save(self, path: pathlib.Path | str | None = None) -> pathlib.Path:
        path = pathlib.Path(path) if path else cache_path(self.arch)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        return path

    @classmethod
    def load(
        cls,
        arch: str | None = None,
        path: pathlib.Path | str | None = None,
    ) -> "TuningCache | None":
        """Re-load a saved cache: None when none was ever written."""
        path = pathlib.Path(path) if path else cache_path(
            arch or _process_arch())
        if not path.exists():
            return None
        return cls.from_json(json.loads(path.read_text()))


# ---------------------------------------------------------------------------
# The active cache dispatch consults
# ---------------------------------------------------------------------------

_active: TuningCache | None = None
_loaded = False


def active_cache() -> TuningCache | None:
    """The cache dispatch consults, loaded from the default path once.

    The file is an optional hint: a missing cache (one log line naming the
    file) and an unreadable one (one warning) both leave dispatch on its
    heuristics. Explicit ``TuningCache.load`` calls keep their errors.
    """
    global _active, _loaded
    if not _loaded:
        arch = _process_arch()
        try:
            _active = TuningCache.load(arch)
            if _active is None:
                logger.info(
                    "no tuning cache for arch '%s' (%s missing): kernel "
                    "dispatch falls back to its heuristics; run "
                    "kernels.autotune.autotune to pin measured winners",
                    arch, cache_path(arch),
                )
        except Exception as e:  # noqa: BLE001 - a hint must not stop serving
            warnings.warn(
                f"ignoring unreadable tuning cache ({cache_path(arch)}): "
                f"{e}; re-run kernels.autotune.autotune to regenerate",
                stacklevel=2,
            )
            _active = None
        _loaded = True
    return _active


def set_active(cache: TuningCache | None) -> None:
    global _active, _loaded
    _active, _loaded = cache, True


def clear_active() -> None:
    """Disable tuned dispatch for this process (heuristics only)."""
    set_active(None)


def reload_active() -> TuningCache | None:
    """Read the default cache path again."""
    global _loaded
    _loaded = False
    return active_cache()


def lookup(variant: str, cell: tuple[int, int, int]) -> Winner | None:
    cache = active_cache()
    return None if cache is None else cache.lookup(variant, cell)


def stale_entries(cache: TuningCache) -> tuple[str, ...]:
    """Entry ids whose winner predates the cache's latest sweep (what a
    partial re-sweep inherited, ``swept_at=0`` entries included)."""
    return tuple(sorted(
        k for k, w in cache.entries.items()
        if w.swept_at < cache.sweep_version
    ))


# ---------------------------------------------------------------------------
# Sweeping
# ---------------------------------------------------------------------------


def cache_from_records(
    arch: str, records: Iterable[Mapping],
    prev: TuningCache | None = None,
) -> TuningCache:
    """A TuningCache from measured-winner records, each with ``variant``,
    ``cell`` ([m, k, n]), ``backend``, ``block`` and ``us``; later records
    win a shared cell. ``prev`` seeds inherited entries at their old
    ``swept_at``; the records stamp the bumped ``sweep_version``."""
    cache = TuningCache(arch=arch)
    if prev is not None:
        cache.entries.update(prev.entries)
        cache.sweep_version = prev.sweep_version
    cache.sweep_version += 1
    for r in records:
        cache.put(
            r["variant"], tuple(int(d) for d in r["cell"]),
            Winner(
                backend=r["backend"],
                block=tuple(r["block"]) if r.get("block") else None,
                us=float(r.get("us", 0.0)),
                swept_at=cache.sweep_version,
            ),
        )
    return cache


def _default_device() -> str:
    """Sweeps run on the card unless the caller asks for the CPU
    (``device="cpu"``); without a card a sweep that does not ask fails."""
    return "cuda"


def default_candidates(
    variant: str,
    *,
    rows: int = 16,
    include_cuda: bool | None = None,
    device: str | torch.device | None = None,
) -> tuple[Candidate, ...]:
    """Candidate (backend, block) pairs for one variant, in
    ``dispatch.backends_for`` order: scan, ref and slots, then on a CUDA
    sweep (``include_cuda``, default: ``device`` is a card, as it is when
    not given) the variant's kernel at each column tile it is built for,
    as ``dispatch.cuda_block(rows, bn)``."""
    if include_cuda is None:
        include_cuda = torch.device(device or _default_device()).type == "cuda"
    cands: list[Candidate] = []
    for backend in dispatch.backends_for(variant):
        if dispatch.lookup(variant, backend) is None:
            continue
        if backend == "cuda":
            if include_cuda:
                cands.extend(("cuda", dispatch.cuda_block(rows, bn))
                             for bn in KERNEL_BNS)
        else:
            cands.append((backend, None))
    return tuple(cands)


def best_of(reps: int, device: torch.device) -> MeasureFn:
    """Best of ``reps`` calls: CUDA events around each on a card, the host
    clock on the CPU."""

    def measure(candidate: Candidate, run: Callable[[], Any]) -> float:
        del candidate
        best = float("inf")
        for _ in range(reps):
            if device.type == "cuda":
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run()
                e.record()
                e.synchronize()
                secs = s.elapsed_time(e) / 1e3
            else:
                t0 = time.perf_counter()
                run()
                secs = time.perf_counter() - t0
            best = min(best, secs)
        return best

    return measure


def sweep_operands(
    spec: MacroSpec, m: int, k: int, n: int, *, seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None,
           torch.Tensor | None]:
    """The operands a served plan gives one macro matmul, from a numpy
    seed, on ``device`` (default: the card, as :func:`sweep_shape`; the
    CPU when ``device="cpu"``): int32 activation codes x [M, K], int8
    weight codes w [K, N], the packed planes (``engine._grouped_planes``)
    and the spread slots (``quant.spread_slots``; None where the point
    cannot pack them)."""
    from repro_torch.core import engine, quant  # engine imports dispatch

    device = torch.device(device or _default_device())
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, spec.act_levels, (m, k))
                         .astype(np.int32)).to(device)
    lo = -(1 << (spec.weight_bits - 1))
    hi = 1 << (spec.weight_bits - 1)
    cdtype = np.int8 if spec.weight_bits <= 8 else np.int32
    w = torch.from_numpy(rng.integers(lo, hi, (k, n)).astype(cdtype)).to(
        device)
    w32 = w.to(torch.int32)
    planes = None
    if spec.weight_bits <= 8:
        planes = engine._grouped_planes(w32, spec, packed=True)
    try:
        slots = quant.spread_slots(w32, spec.rows_active, spec.act_bits,
                                   spec.weight_bits)
    except ValueError:  # infeasible operating point for slot packing
        slots = None
    return x, w, planes, slots


class NoFeasibleCandidate(RuntimeError):
    """Every candidate of a sweep was infeasible at its shape."""


def sweep_shape(
    variant: str,
    spec: CIMConfig | MacroSpec | None,
    m: int,
    k: int,
    n: int,
    *,
    candidates: Sequence[Candidate] | None = None,
    measure: MeasureFn | None = None,
    reps: int = 3,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Winner:
    """Time every candidate at one shape on ``device`` (default: the card;
    a CPU sweep passes ``device="cpu"``); return the pinned winner.

    Each candidate runs on the operands a served plan provides
    (:func:`sweep_operands`), so plan-dependent backends ("slots") are
    sweepable. Deterministic given a deterministic ``measure``:
    candidates run in their stable order, and ties keep the earlier one.
    A candidate that raises ``ValueError`` (infeasible here) is skipped
    and never wins; every other error propagates.
    """
    device = torch.device(device or _default_device())
    spec = as_spec(spec) if spec is not None else MacroSpec()
    spec = spec.replace(noisy=False)
    if candidates is None:
        candidates = default_candidates(variant, rows=spec.rows_active,
                                        device=device)
    if measure is None:
        measure = best_of(reps, device)
    x, w, planes, slots = sweep_operands(spec, m, k, n, seed=seed,
                                         device=device)

    best: Winner | None = None
    for backend, block in candidates:
        def run(_b=backend, _blk=block):
            with torch.no_grad():
                out = dispatch.dispatch(x, w, spec, variant=variant,
                                        backend=_b, block=_blk,
                                        planes=planes, slots=slots)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return out

        try:
            run()
        except ValueError:  # infeasible at this shape or operating point
            continue
        secs = float(measure((backend, block), run))
        if best is None or secs * 1e6 < best.us:
            best = Winner(backend=backend, block=block, us=secs * 1e6)
    if best is None:
        raise NoFeasibleCandidate(
            f"no feasible kernel candidate for variant='{variant}' at "
            f"shape ({m}, {k}, {n})"
        )
    return best


def autotune(
    shapes: Iterable[tuple[int, int, int]],
    spec: CIMConfig | MacroSpec | None = None,
    *,
    variants: Sequence[str] = ("p8t", "adder-tree", "cell-adc"),
    arch: str | None = None,
    save: bool = True,
    path: pathlib.Path | str | None = None,
    activate: bool = True,
    merge: bool = True,
    device: str | torch.device | None = None,
    **sweep_kw,
) -> TuningCache:
    """Sweep a (variants x shapes) grid on ``device`` and persist and
    activate the winners.

    One entry per (variant, shape cell); where several shapes fall in one
    cell the last sweep wins (pass one representative per cell). ``save``
    writes the cache to ``path`` (default: ``cache_path(arch)``);
    ``activate`` makes it the cache dispatch consults in this process.
    ``merge`` seeds the result with the entries saved at that path, so a
    partial re-sweep updates only the swept cells. Either way
    ``sweep_version`` bumps and the swept cells are stamped with it.
    """
    device = torch.device(device or _default_device())
    arch = arch or device_arch(device)
    shapes = tuple(shapes)  # generators must survive the variant loop
    cache = TuningCache(arch=arch)
    if merge:
        prev = TuningCache.load(arch=arch, path=path)
        if prev is not None:
            cache.entries.update(prev.entries)
            cache.sweep_version = prev.sweep_version
    cache.sweep_version += 1
    for variant in variants:
        for (m, k, n) in shapes:
            cell = dispatch.shape_cell(m, k, n)
            win = sweep_shape(variant, spec, m, k, n, device=device,
                              **sweep_kw)
            cache.put(
                variant, cell,
                dataclasses.replace(win, swept_at=cache.sweep_version),
            )
    if save:
        cache.save(path)
    if activate:
        set_active(cache)
    return cache
