"""Variant-aware kernel dispatch: one table for every macro matmul.

A ``KernelKey(variant, backend, shape_cell, dtype) -> implementation``
map that ``engine.execute``'s behavioral and cuda backends route through.

Backends registered for each macro variant (``core.variants``):

  "scan"    the group-loop transfer (p8t and cell-adc:
            core.matmul.cim_matmul_int; adder-tree:
            core.variants.adder_tree_matmul_int). The only backend that
            takes a noise request; peak memory is one group tile, so it
            is the large-shape default.
  "ref"     the vectorized formulation (kernels.ref.cim_matmul_ref;
            adder-tree: adder_tree_matmul_ref).
  "slots"   the spread-slot formulation (kernels.ref.cim_matmul_slots;
            adder-tree: adder_tree_matmul_slots); needs the plan's
            ``slots`` operand grouped at the executing rows_active (it
            cannot be regrouped).
  "cuda"    the variant's hand-written Hopper kernel (kernels.cim_mac:
            gpq_matmul B1, adder_tree_gpq_matmul B2, cell_adc_gpq_matmul
            B3). Noiseless. Consumes a plan's packed planes directly
            (flatten-sliced to the [K, N] byte matrix). Takes a ``block``
            (bm, bn, bk) = ``cuda_block(rows, bn)``: 64 rows (four m16
            warps), the column tile bn, and the k slots a row group walks;
            only bn is a choice.

The cell-ADC's ideal transfer is the P-8T floor transfer, so its scan,
ref and slots entries reuse the P-8T formulations; its kernel is the
distinct SAR search (bit-identical codes).

Resolution order when no backend is requested explicitly:

  1. hardware-noise injection (``spec.noisy`` and a generator) requires
     the scan transfer, recorded as source="noise";
  2. the autotune cache (``kernels.autotune``): the pinned winner for
     (arch, variant, shape cell), with its block, recorded as
     source="tuned";
  3. heuristics: the slots form at small M when the plan carries it;
     the variant's kernel when the operands are on a CUDA device and the
     plan has no unpacked planes; otherwise the scan.

A tuned "cuda" pin fixes only the column tile bn: the call runs at
``cuda_block(spec.rows_active, bn)``, so a cache swept at another
rows_active still applies. A pin this call cannot take (a backend not
registered for the variant, a bn the kernels are not built for, a slots
pin on a call without slots) is checked before anything runs: the
heuristics pick instead, recorded as "tuned-fallback".

An explicit ``backend=`` request is always honored and any error it
raises propagates; a noise request to an explicit backend that cannot
draw noise (ref, slots, cuda) raises rather than run noiseless. An
implicit pick, tuned or heuristic, that raises the kernel's depth guard
(``DepthGuardError``, a ``ValueError``) falls back to the scan and
is recorded as "guard-fallback", and one whose operating point the
kernel does not take (``KernelSpecError``: B1, B2 and B3 at act_bits >
8 or over 32 active rows) as "spec-fallback". Every other error
(operand faults, build and launch errors) propagates.
``record_resolutions`` lets callers assert exactly which implementation
ran.

An implementation is ``fn(x_codes, w_codes, spec, *, generator=None,
planes=None) -> [M, N] float32`` in integer-domain macro units (plus
``slots=`` for implementations registered with ``supports_slots``, and
``block=`` for kernels, ``is_kernel``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator

import torch

from repro_torch.core import matmul as matmul_lib
from repro_torch.core import variants as variants_lib
from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec, as_spec
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.cim_mac import (
    KERNEL_BNS,
    PLANE_BM,
    DepthGuardError,
    KernelSpecError,
)

# fn(x_codes, w_codes, spec, *, generator, planes) -> [M, N] f32
KernelFn = Callable[..., torch.Tensor]

# Backend preference order (autotune's candidate order too).
KNOWN_BACKENDS = ("scan", "ref", "slots", "cuda")

Block = tuple[int, int, int]


def cuda_block(rows: int, bn: int) -> Block:
    """The "cuda" kernels' block (bm, bn, bk) at ``rows_active`` and
    column tile ``bn``: bm = 64 (four m16 warps a block), bk = the k slots
    a row group walks (16 per k16 step, rows <= 16 in one step)."""
    return (PLANE_BM, bn, 16 * -(-rows // 16))


@dataclasses.dataclass(frozen=True)
class KernelKey:
    """Registration/lookup key of one kernel implementation.

    ``shape_cell``/``dtype`` of None are wildcards; a non-None cell or
    dtype registers a specialized kernel that wins over the generic one
    (most-specific-first lookup).
    """

    variant: str
    backend: str
    shape_cell: tuple[int, int, int] | None = None
    dtype: str | None = None


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """A registered implementation plus its capability flags."""

    fn: KernelFn
    supports_noise: bool = False
    supports_planes: bool = False
    supports_slots: bool = False
    is_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class Resolution:
    """One dispatch decision."""

    key: KernelKey
    # "explicit" | "noise" | "tuned" | "heuristic" | "guard-fallback" |
    # "spec-fallback" | "tuned-fallback"
    source: str
    block: Block | None = None  # a kernel's (bm, bn, bk)


_TABLE: dict[KernelKey, KernelImpl] = {}
_LISTENERS: list[Callable[[Resolution], None]] = []


def register_kernel(
    key: KernelKey,
    fn: KernelFn,
    *,
    supports_noise: bool = False,
    supports_planes: bool = False,
    supports_slots: bool = False,
    is_kernel: bool = False,
) -> KernelKey:
    """Register one implementation under a KernelKey. Returns the key."""
    if key in _TABLE:
        raise ValueError(f"kernel {key} already registered")
    _TABLE[key] = KernelImpl(
        fn=fn,
        supports_noise=supports_noise,
        supports_planes=supports_planes,
        supports_slots=supports_slots,
        is_kernel=is_kernel,
    )
    return key


def backends_for(variant: str) -> tuple[str, ...]:
    """Registered backends of one variant, in preference order."""
    got = {k.backend for k in _TABLE if k.variant == variant}
    ordered = [b for b in KNOWN_BACKENDS if b in got]
    return tuple(ordered + sorted(got - set(KNOWN_BACKENDS)))


def has_kernel(variant: str) -> bool:
    return any(k.variant == variant and _TABLE[k].is_kernel for k in _TABLE)


_CELL_CAP = 8192


def shape_cell(m: int, k: int, n: int) -> tuple[int, int, int]:
    """Bucket a concrete (M, K, N) into its tuning cell: each dim rounds
    up to the next power of two, capped at 8192."""

    def cell(d: int) -> int:
        p = 1
        while p < d and p < _CELL_CAP:
            p *= 2
        return p

    return (cell(m), cell(k), cell(n))


def lookup(
    variant: str,
    backend: str,
    shape_cell: tuple[int, int, int] | None = None,
    dtype: str | None = None,
) -> KernelImpl | None:
    """Most-specific-first table lookup."""
    for key in (
        KernelKey(variant, backend, shape_cell, dtype),
        KernelKey(variant, backend, shape_cell, None),
        KernelKey(variant, backend, None, dtype),
        KernelKey(variant, backend, None, None),
    ):
        impl = _TABLE.get(key)
        if impl is not None:
            return impl
    return None


@contextlib.contextmanager
def record_resolutions() -> Iterator[list[Resolution]]:
    """Capture every dispatch decision made inside the context."""
    log: list[Resolution] = []
    _LISTENERS.append(log.append)
    try:
        yield log
    finally:
        _LISTENERS.remove(log.append)


def _notify(res: Resolution) -> None:
    for cb in _LISTENERS:
        cb(res)


def _has_backend(variant: str, backend: str) -> bool:
    return any(k.variant == variant and k.backend == backend for k in _TABLE)


# Largest M for which the heuristic takes the slots formulation: its
# weight traffic is M-independent, so it wins the decode shapes.
_SLOTS_HEURISTIC_MAX_M = 32


def _heuristic_backend(
    variant: str, planes, slots, m: int, device: torch.device
) -> str:
    if (
        slots is not None
        and m <= _SLOTS_HEURISTIC_MAX_M
        and _has_backend(variant, "slots")
    ):
        return "slots"
    # Unpacked pre-grouped planes are a weight-stationary optimization
    # the kernel does not consume (packed planes it does, via the
    # flatten-slice path): implicit routing keeps the plan semantics and
    # takes the scan.
    if (
        (planes is None or planes.ndim == 3)
        and device.type == "cuda"
        and has_kernel(variant)
    ):
        return "cuda"
    return "scan"


def _tuned_pick(
    win, variant: str, cell, dtype: str, rows: int, slots,
    block: Block | None,
) -> tuple[str, Block | None] | None:
    """The (backend, block) a tuned winner pins for this call, or None
    when the call cannot take the pin. A kernel pin keeps only its bn;
    an explicit ``block`` wins over it."""
    impl = lookup(variant, win.backend, cell, dtype)
    if impl is None or (impl.supports_slots and slots is None):
        return None
    if not impl.is_kernel or block is not None or win.block is None:
        return win.backend, block
    if len(win.block) != 3 or win.block[1] not in KERNEL_BNS:
        return None
    return win.backend, cuda_block(rows, win.block[1])


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def dispatch(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    spec: CIMConfig | MacroSpec,
    *,
    variant: str = "p8t",
    backend: str | None = None,
    generator: torch.Generator | None = None,
    planes: torch.Tensor | None = None,
    slots: torch.Tensor | None = None,
    block: Block | None = None,
) -> torch.Tensor:
    """Route one integer-domain macro matmul to its implementation.

    Args:
      x_codes: [M, K] activation codes; w_codes: [K, N] signed weight
        codes (a plan's ``codes``, any integer dtype).
      spec: the operating point.
      variant: macro family name ("p8t", "adder-tree" or "cell-adc").
      backend: explicit implementation choice; None = tuned, else
        heuristic.
      generator: hardware-noise request; routes an implicit pick to the
        scan transfer.
      planes: plan-grouped bit planes, forwarded to implementations that
        consume them; regrouped to ``spec.rows_active`` only when the
        chosen implementation reads them.
      slots: plan spread-slot operand; dropped when grouped at another
        rows_active.
      block: a kernel's (bm, bn, bk) (``cuda_block``); defaults to the
        tuned winner's bn at ``spec.rows_active``, else the kernel's
        choice by N.
    """
    spec = as_spec(spec)
    m, k = x_codes.shape
    n = w_codes.shape[-1]
    cell = shape_cell(m, k, n)
    dtype = _dtype_name(w_codes)
    noisy = bool(spec.noisy) and generator is not None
    if slots is not None and slots.shape[-2] != spec.rows_active:
        slots = None  # the slot fields encode the grouping irreversibly

    source = "explicit"
    if backend is None:
        if noisy:
            backend, source = "scan", "noise"
        else:
            from repro_torch.kernels import autotune  # autotune imports us

            win = autotune.lookup(variant, cell)
            pick = None if win is None else _tuned_pick(
                win, variant, cell, dtype, spec.rows_active, slots, block)
            if pick is not None:
                (backend, block), source = pick, "tuned"
            else:
                backend = _heuristic_backend(
                    variant, planes, slots, m, x_codes.device
                )
                source = "heuristic" if win is None else "tuned-fallback"

    impl = lookup(variant, backend, cell, dtype)
    if impl is None:
        raise KeyError(
            f"no kernel registered for variant='{variant}' "
            f"backend='{backend}' (cell={cell}, dtype={dtype}); "
            f"registered backends for this variant: {backends_for(variant)}"
        )
    if noisy and not impl.supports_noise:
        raise ValueError(
            f"backend '{backend}' of variant '{variant}' is noiseless and "
            "cannot take the hardware-noise request (a noisy spec with a "
            "generator); leave the backend implicit to run the scan")
    _notify(Resolution(key=KernelKey(variant, backend, cell, dtype),
                       source=source,
                       block=block if impl.is_kernel else None))

    def planes_for(chosen: KernelImpl):
        if not chosen.supports_planes or planes is None:
            return None
        if chosen.is_kernel or planes.shape[-2] == spec.rows_active:
            # The kernel's flatten-slice path recovers the [K, N] byte
            # matrix at any grouping: no regroup needed there.
            return planes
        from repro_torch.core import engine  # engine imports dispatch

        return engine.regroup_planes(planes, k, spec.rows_active)

    def run(chosen: KernelImpl):
        kwargs: dict[str, Any] = dict(
            generator=generator if noisy else None,
            planes=planes_for(chosen),
        )
        if chosen.supports_slots:
            kwargs["slots"] = slots
        if chosen.is_kernel:
            kwargs["block"] = block
        return chosen.fn(x_codes, w_codes, spec, **kwargs)

    if source == "explicit" or backend == "scan":
        return run(impl)
    try:
        return run(impl)
    except (DepthGuardError, KernelSpecError) as e:
        # The implicit pick is infeasible at this depth or operating point:
        # fall back to the always-feasible scan and record it. Explicit
        # requests raise above; every other error propagates.
        scan = lookup(variant, "scan", cell, dtype)
        if scan is None:
            raise
        _notify(Resolution(
            key=KernelKey(variant, "scan", cell, dtype),
            source=("guard-fallback" if isinstance(e, DepthGuardError)
                    else "spec-fallback"),
        ))
        return run(scan)


# ---------------------------------------------------------------------------
# Built-in implementations
# ---------------------------------------------------------------------------


def _ref_impl(ref_fn: KernelFn) -> KernelFn:
    def run(x_codes, w_codes, spec, *, generator=None, planes=None):
        del generator  # noiseless vectorized formulation
        return ref_fn(x_codes, w_codes, spec, planes=planes)

    return run


def _slots_impl(slots_fn: KernelFn) -> KernelFn:
    def run(x_codes, w_codes, spec, *, generator=None, planes=None,
            slots=None):
        del w_codes, generator, planes  # weight side IS the slot operand
        if slots is None:
            raise ValueError(
                "slots backend requires a plan's spread-slot operand "
                "grouped at the executing rows_active "
                "(engine.plan_weights keeps one under the behavioral "
                "mode); none provided"
            )
        return slots_fn(x_codes, slots, spec)

    return run


def _cuda_impl(kernel_name: str) -> KernelFn:
    def run(x_codes, w_codes, spec, *, generator=None, planes=None,
            block=None):
        del generator  # noiseless
        bn = None
        if block is not None:
            bn = block[1]
            want = cuda_block(spec.rows_active, bn)
            if tuple(block) != want:
                raise ValueError(f"block {tuple(block)} is not the cuda "
                                 f"kernels' {want} at rows_active="
                                 f"{spec.rows_active}")
        from repro_torch.kernels import ops  # loads the wrappers lazily

        if planes is not None and planes.ndim == 3:
            # Packed plan planes [G, rows, N] uint8: bit b of each byte
            # is the weight's two's-complement bit b, exactly the masked
            # code the kernels read. The flatten-slice recovers the
            # [K, N] byte matrix at any grouping (the K-tail padding rows
            # drop here).
            k = x_codes.shape[1]
            w_codes = planes.reshape(-1, planes.shape[-1])[:k]
        return getattr(ops, kernel_name)(x_codes, w_codes, spec, bn=bn)

    return run


# One literal registration per key, as the JAX package writes them (the
# registry rule of ``repro.analysis`` reads these call sites). The scan
# twins already take the implementation signature.
register_kernel(
    KernelKey("p8t", "scan"), matmul_lib.cim_matmul_int,
    supports_noise=True, supports_planes=True,
)
register_kernel(
    KernelKey("p8t", "ref"), _ref_impl(ref_lib.cim_matmul_ref),
    supports_planes=True,
)
register_kernel(
    KernelKey("p8t", "slots"), _slots_impl(ref_lib.cim_matmul_slots),
    supports_slots=True,
)
register_kernel(
    KernelKey("p8t", "cuda"), _cuda_impl("cim_matmul_kernel"),
    supports_planes=True, is_kernel=True,
)

# cell-adc: the ideal transfer equals the P-8T floor transfer, so scan,
# ref and slots reuse those formulations; the kernel is B3's SAR search
# (bit-identical codes).
register_kernel(
    KernelKey("cell-adc", "scan"), matmul_lib.cim_matmul_int,
    supports_noise=True, supports_planes=True,
)
register_kernel(
    KernelKey("cell-adc", "ref"), _ref_impl(ref_lib.cim_matmul_ref),
    supports_planes=True,
)
register_kernel(
    KernelKey("cell-adc", "slots"), _slots_impl(ref_lib.cim_matmul_slots),
    supports_slots=True,
)
register_kernel(
    KernelKey("cell-adc", "cuda"), _cuda_impl("cell_adc_matmul_kernel"),
    supports_planes=True, is_kernel=True,
)

register_kernel(
    KernelKey("adder-tree", "scan"), variants_lib.adder_tree_matmul_int,
    supports_noise=True, supports_planes=True,
)
register_kernel(
    KernelKey("adder-tree", "ref"),
    _ref_impl(ref_lib.adder_tree_matmul_ref),
    supports_planes=True,
)
register_kernel(
    KernelKey("adder-tree", "slots"),
    _slots_impl(ref_lib.adder_tree_matmul_slots),
    supports_slots=True,
)
register_kernel(
    KernelKey("adder-tree", "cuda"), _cuda_impl("adder_tree_matmul_kernel"),
    supports_planes=True, is_kernel=True,
)
