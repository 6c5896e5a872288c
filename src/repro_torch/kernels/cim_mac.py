"""The GPQ matmuls of the three macro variants: hand-written Hopper
kernels and their plain versions.

Each wrapper computes what the reference's Pallas kernel of the same
name in ``repro/kernels/cim_mac.py`` computes, for activation codes
x [M, K] and weight bytes w [K, N] (int8 signed codes or a plan's uint8
packed-plane bytes), with

  pMAC[m, g, b, n] = sum_{k in group g} x[m, k] * bit_b(w[k, n])

  gpq_matmul             (P-8T, B1) per-plane flash codes
                         clip(floor(pMAC / adc_step + 1/2 * nearest),
                         0, adc_codes - 1);
                         out = sum_g sum_b s_b 2^b code * adc_step
  adder_tree_gpq_matmul  (B2) one merged conversion per group:
                         merged = sum_b s_b 2^b pMAC,
                         code = clip(floor(merged / step + 1/2 * nearest),
                         code_min, code_max) with variants.merged_quant;
                         out = sum_g code * step
  cell_adc_gpq_matmul    (B3) the adc_bits-step SAR search per pMAC
                         against the levels t * adc_step (the same codes
                         as B1); dequant and shift-add as B1

with s_b = -1 on the MSB plane. On a CUDA tensor a wrapper launches its
kernel from ``csrc/<name>.cu`` (built on first use by ``kernels.build``)
or raises; on a CPU tensor it runs its ``*_plain`` version, the same
function in plain PyTorch ops following the reference's float
arithmetic, which is also what the kernel is held to on the card. There
is no fallback from one to the other. On meta tensors (the dry run's
shape-only steps) a wrapper makes a launch's checks, the depth guard
included, and returns an empty float32 [M, N] meta tensor: nothing is
built, launched or counted.

Each wrapper takes an optional ``bn``, the kernel's column tile (16, 32
or 64; None or 0 picks it by N, as before), the block an autotuned pin
fixes. Any other value raises, on either device.

``LAUNCHES`` counts kernel launches by kernel name; it moves only where
a kernel is launched.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec
from repro_torch.core.quant import plane_signs, true_divide
from repro_torch.core.variants import merged_quant
from repro_torch.kernels import build

LAUNCHES: collections.Counter[str] = collections.Counter()


class DepthGuardError(ValueError):
    """K is past the reference's exact-accumulation depth."""


class KernelSpecError(ValueError):
    """The operating point is one the CUDA kernels do not take (act_bits
    > 8 or more than 32 active rows, for all three); the plain version
    takes it."""


def _depth_guard(k: int, spec: MacroSpec) -> None:
    """The reference's f32 exact-accumulation bound of the per-plane
    kernels (B1, B3), kept as the contract.

    The kernels accumulate in int32 and could go deeper; they raise where
    the reference raises, so both packages accept the same depths.
    """
    rows = spec.rows_active
    # bound: G * 2**(weight_bits - 1) * threshold < 2**23 * adc_step
    max_abs = (k + rows - 1) // rows * (1 << (spec.weight_bits - 1)) * spec.threshold
    if max_abs >= (1 << 24) * 0.5 * spec.adc_step:
        raise DepthGuardError(
            f"K={k} too deep for exact f32 accumulation at this operating "
            "point; use core.matmul.cim_matmul_int"
        )


def _merged_depth_guard(k: int, spec: MacroSpec) -> None:
    """The reference's bound on B2's f32 sum of merged codes."""
    rows = spec.rows_active
    mq = merged_quant(spec)
    # bound: G * max(-code_min, code_max) < 2**24
    g = (k + rows - 1) // rows
    if g * max(abs(mq.code_min), mq.code_max) >= (1 << 24):
        raise DepthGuardError(
            f"K={k} too deep for exact f32 accumulation of merged codes; "
            "use variants.adder_tree_matmul_int"
        )


def _unpacked_planes(w: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """[K, N] codes or packed bytes -> [K, B, N] 0/1 planes (f32)."""
    mask = (1 << weight_bits) - 1
    u = torch.bitwise_and(w.to(torch.int32), mask)
    shifts = torch.arange(weight_bits, dtype=torch.int32, device=w.device)
    planes = torch.bitwise_and(
        torch.bitwise_right_shift(u[:, None, :], shifts[None, :, None]), 1
    )
    return planes.to(torch.float32)


def _plain_pmac(x_codes, w_codes, spec: MacroSpec) -> torch.Tensor:
    """[M, K] codes x [K, N] bytes -> [G, M, B, N] f32 group pMACs.

    One [G, M, B*N] contraction, so its memory grows with G * M * B * N.
    Group pMACs <= rows * act_max are exact in f32 (also under TF32,
    whose 11-bit significand holds codes and 0/1 planes exactly).
    """
    m, k = x_codes.shape
    if w_codes.shape[0] != k:
        raise ValueError(f"K mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    n = w_codes.shape[1]
    rows = spec.rows_active
    b = spec.weight_bits
    g = -(-k // rows)
    kp = g * rows
    x = torch.nn.functional.pad(x_codes.to(torch.float32), (0, kp - k))
    xg = x.reshape(m, g, rows).transpose(0, 1)  # [G, M, rows]
    planes = _unpacked_planes(w_codes, b)  # [K, B, N]
    planes = torch.nn.functional.pad(planes, (0, 0, 0, 0, 0, kp - k))
    pe = planes.reshape(g, rows, b * n)  # [G, rows, B*N]
    return torch.bmm(xg, pe).reshape(g, m, b, n)


def _plane_weights(spec: MacroSpec, device) -> torch.Tensor:
    """[B, 1] f32 shift-add weights s_b 2^b, broadcast over N."""
    return plane_signs(spec.weight_bits, device).to(torch.float32)[:, None]


def _plane_shift_add(code: torch.Tensor, spec: MacroSpec) -> torch.Tensor:
    """[G, M, B, N] plane codes -> sum_g sum_b s_b 2^b code * adc_step."""
    return (code * spec.adc_step * _plane_weights(spec, code.device)).sum(
        dim=(0, 2))


def _flash_codes(pmac: torch.Tensor, spec: MacroSpec) -> torch.Tensor:
    """B1's codes of f32 pMACs: ``floor(pMAC / adc_step + half)`` in f32,
    clipped to [0, adc_codes - 1]."""
    half = 0.5 if spec.adc_mode == "nearest" else 0.0
    return torch.clamp(
        torch.floor(true_divide(pmac, spec.adc_step) + half), 0,
        spec.adc_codes - 1,
    )


def _sar_codes(pmac: torch.Tensor, spec: MacroSpec) -> torch.Tensor:
    """B3's int32 codes of f32 pMACs: the reference's unrolled SAR search,
    ``take = pMAC + half_step >= trial * adc_step`` (every term an exact
    f32 value)."""
    thresh_off = 0.5 * spec.adc_step if spec.adc_mode == "nearest" else 0.0
    code = torch.zeros(pmac.shape, dtype=torch.int32, device=pmac.device)
    for bit in range(spec.adc_bits - 1, -1, -1):
        trial = torch.bitwise_or(code, 1 << bit)
        take = pmac + thresh_off >= trial.to(torch.float32) * spec.adc_step
        code = torch.where(take, trial, code)
    return code


def gpq_matmul_plain(
    x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig | MacroSpec
) -> torch.Tensor:
    """B1 in plain PyTorch ops: the kernel's reference version.

    Follows the Pallas kernel's float arithmetic: f32 group pMACs, codes
    from ``floor(pMAC / adc_step + half)`` in f32, dequantized codes
    summed with the plane signs.
    """
    spec = MacroSpec.from_config(cfg)
    _depth_guard(x_codes.shape[1], spec)
    pmac = _plain_pmac(x_codes, w_codes, spec)
    return _plane_shift_add(_flash_codes(pmac, spec), spec)


def adder_tree_gpq_matmul_plain(
    x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig | MacroSpec
) -> torch.Tensor:
    """B2 in plain PyTorch ops, in the reference's plane formulation:
    f32 group pMACs per plane, merged with the plane signs, one code per
    (group, output) from ``floor(merged / step + half)`` in f32. (The
    kernel computes the merged value as one signed dot product; the card
    check holds the two to each other.)"""
    spec = MacroSpec.from_config(cfg)
    _merged_depth_guard(x_codes.shape[1], spec)
    pmac = _plain_pmac(x_codes, w_codes, spec)
    # [G, M, N], exact: |merged| <= 2**(B-1) * pmac_max < 2**24
    merged = (pmac * _plane_weights(spec, pmac.device)).sum(dim=2)
    mq = merged_quant(spec)
    half = 0.5 if spec.adc_mode == "nearest" else 0.0
    code = torch.clamp(
        torch.floor(true_divide(merged, mq.step) + half), mq.code_min,
        mq.code_max,
    )
    return code.sum(dim=0) * mq.step


def cell_adc_gpq_matmul_plain(
    x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig | MacroSpec
) -> torch.Tensor:
    """B3 in plain PyTorch ops: B1's f32 group pMACs, then the reference's
    unrolled SAR search (:func:`_sar_codes`)."""
    spec = MacroSpec.from_config(cfg)
    _depth_guard(x_codes.shape[1], spec)
    pmac = _plain_pmac(x_codes, w_codes, spec)
    return _plane_shift_add(_sar_codes(pmac, spec).to(torch.float32), spec)


def _check_operands(x: torch.Tensor, w: torch.Tensor,
                    spec: MacroSpec) -> None:
    """What a launch takes: x and w on one CUDA device (or both on meta,
    the shape-only path), their dtypes, shapes and layout."""
    if x.device.type not in ("cuda", "meta") or w.device != x.device:
        raise ValueError(
            f"the GPQ kernels need x and w on one CUDA device (or both on "
            f"meta); got {x.device} and {w.device}"
        )
    if x.dtype != torch.int32:
        raise TypeError(f"x codes must be int32, got {x.dtype}")
    if w.dtype not in (torch.int8, torch.uint8):
        raise TypeError(
            f"w must be int8 codes or uint8 packed bytes, got {w.dtype}"
        )
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"need x [M, K] and w [K, N]; got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (row-major)")
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 1 << 31:
        raise ValueError("dimensions must fit in int32")
    if spec.weight_bits > 8:
        raise ValueError("the kernels take weight_bits <= 8 (one byte each)")


def _check_plane_spec(spec: MacroSpec) -> None:
    """What the tensor-core kernel of B1, B2 and B3 takes: activation
    codes as unsigned bytes, a row group in at most two k16 steps."""
    if spec.act_bits > 8:
        raise KernelSpecError(
            f"the GPQ kernels take act_bits <= 8 (codes in [0, 256) "
            f"as unsigned bytes); got act_bits={spec.act_bits}"
        )
    if spec.rows_active > 32:
        raise KernelSpecError(
            f"the GPQ kernels take rows_active <= 32; got "
            f"{spec.rows_active}"
        )


# The column tiles the tensor-core kernel is instantiated for
# (csrc/plane_mma.cuh, launch_plane_ks), and its rows per block (four m16
# warps, kPlaneBM).
KERNEL_BNS = (16, 32, 64)
PLANE_BM = 64


def check_bn(bn: int | None) -> int:
    """``bn`` as the launchers take it: 0 for None or 0 (the choice by N),
    else one of KERNEL_BNS; anything else raises ValueError."""
    if not bn:
        return 0
    if bn not in KERNEL_BNS:
        raise ValueError(f"bn={bn!r}: the GPQ kernels' column tile is one "
                         f"of {KERNEL_BNS} (or None/0 to pick it by N)")
    return int(bn)


_BOUND: set[str] = set()


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, *args,
            stream: int) -> torch.Tensor:
    """Launch kernel ``name`` on [M, K] x [K, N] without synchronising.

    ``args`` are the kernel's scalar arguments after (x, w, out, M, K,
    N), its column tile ``bn`` last: Python ints pass as C ints, floats as
    C floats. Counts the launch.
    """
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = build.library(name)
    fn = getattr(lib, f"{name}_launch")
    if name not in _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i] + [
            i if isinstance(a, int) else ctypes.c_float for a in args
        ] + [p]
        fn.restype = i
        lib.gpq_error_string.argtypes = [i]
        lib.gpq_error_string.restype = ctypes.c_char_p
        _BOUND.add(name)
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, *args,
            stream)
    if rc != 0:
        msg = lib.gpq_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return out


def _on_cpu(x: torch.Tensor, w: torch.Tensor) -> bool:
    return x.device.type == "cpu" and w.device.type == "cpu"


def _abstract_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The output of a call on meta tensors (after the launch's checks):
    its shape and dtype, nothing launched or counted (the counterpart of
    a Pallas call's abstract evaluation)."""
    return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                       device="meta")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def gpq_matmul(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
    *,
    bn: int | None = None,
) -> torch.Tensor:
    """P-8T GPQ matmul (B1) [M, K] x [K, N] -> [M, N] float32.

    ``x_codes`` are activation codes in ``[0, 2**act_bits)``, as
    ``quant.quantize_acts`` makes them. CPU tensors run
    :func:`gpq_matmul_plain`. CUDA tensors launch the hand-written kernel
    on the current stream, without synchronising; it reads each code as an
    unsigned byte, so it takes ``act_bits <= 8`` (and at most 32 active
    rows), and anything else it does not take (dtype, layout, device)
    raises. Both raise ``DepthGuardError`` past the reference's depth
    guard.
    """
    spec = MacroSpec.from_config(cfg)
    bn = check_bn(bn)
    if _on_cpu(x_codes, w_codes):
        return gpq_matmul_plain(x_codes, w_codes, spec)
    _check_plane_spec(spec)
    _check_operands(x_codes, w_codes, spec)
    _depth_guard(x_codes.shape[1], spec)
    if x_codes.is_meta:
        return _abstract_out(x_codes, w_codes)
    return _launch(
        "gpq_matmul", x_codes, w_codes, spec.rows_active, spec.weight_bits,
        spec.adc_bits, spec.threshold, spec.adc_codes,
        int(spec.adc_mode == "nearest"), float(spec.adc_step), bn,
        stream=_stream(x_codes),
    )


def adder_tree_gpq_matmul(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
    *,
    bn: int | None = None,
) -> torch.Tensor:
    """Adder-tree GPQ matmul (B2) [M, K] x [K, N] -> [M, N] float32.

    ``x_codes`` are activation codes in ``[0, 2**act_bits)``. CPU tensors
    run :func:`adder_tree_gpq_matmul_plain`; CUDA tensors launch
    ``csrc/adder_tree_gpq_matmul.cu`` (``act_bits <= 8``, at most 32
    active rows, as B1) or raise. Both raise ``DepthGuardError`` past the
    reference's merged-code depth guard.
    """
    spec = MacroSpec.from_config(cfg)
    bn = check_bn(bn)
    if _on_cpu(x_codes, w_codes):
        return adder_tree_gpq_matmul_plain(x_codes, w_codes, spec)
    _check_plane_spec(spec)
    _check_operands(x_codes, w_codes, spec)
    _merged_depth_guard(x_codes.shape[1], spec)
    if x_codes.is_meta:
        return _abstract_out(x_codes, w_codes)
    mq = merged_quant(spec)
    return _launch(
        "adder_tree_gpq_matmul", x_codes, w_codes, spec.rows_active,
        spec.weight_bits, mq.code_min, mq.code_max,
        int(spec.adc_mode == "nearest"), float(mq.step), bn,
        stream=_stream(x_codes),
    )


def cell_adc_gpq_matmul(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
    *,
    bn: int | None = None,
) -> torch.Tensor:
    """Cell-embedded-ADC GPQ matmul (B3) [M, K] x [K, N] -> [M, N] f32.

    ``x_codes`` are activation codes in ``[0, 2**act_bits)``. CPU tensors
    run :func:`cell_adc_gpq_matmul_plain`; CUDA tensors launch
    ``csrc/cell_adc_gpq_matmul.cu`` (``act_bits <= 8``, at most 32 active
    rows, as B1) or raise. Both raise ``DepthGuardError`` past the
    reference's depth guard (B1's).
    """
    spec = MacroSpec.from_config(cfg)
    bn = check_bn(bn)
    if _on_cpu(x_codes, w_codes):
        return cell_adc_gpq_matmul_plain(x_codes, w_codes, spec)
    _check_plane_spec(spec)
    _check_operands(x_codes, w_codes, spec)
    _depth_guard(x_codes.shape[1], spec)
    # The SAR compares pMAC * 2^(adc_bits+1) + threshold against
    # 2 * trial * threshold in int32, with the pMAC clamped to the
    # threshold.
    if spec.threshold * (4 << spec.adc_bits) >= 1 << 31:
        raise ValueError("the cell-ADC kernel's int32 compares do not "
                         "cover this operating point")
    if x_codes.is_meta:
        return _abstract_out(x_codes, w_codes)
    return _launch(
        "cell_adc_gpq_matmul", x_codes, w_codes, spec.rows_active,
        spec.weight_bits, spec.adc_bits, spec.threshold,
        int(spec.adc_mode == "nearest"), float(spec.adc_step), bn,
        stream=_stream(x_codes),
    )
