"""Quantizers and bit-slicing for the CIM datapath.

The macro consumes unsigned ``act_bits``-wide activation codes and 1-bit
weight planes sliced from signed ``weight_bits`` integers (two's
complement; the MSB plane carries weight -2**(B-1) in the digital
shift-add). Signed activations use an asymmetric zero-point whose
``-scale * zero_point * sum(W)`` correction happens digitally.

Rounding is ``torch.round`` (ties to even), as in the reference; the
percentile range statistic is :func:`percentile`, which reproduces the
reference's float32 linear interpolation bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def true_divide(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as IEEE division, on every device.

    On CUDA, PyTorch divides by a Python (CPU) scalar as ``a * (1 / b)``,
    which is not correctly rounded: ``12k * f32(1/12)`` can land just
    below ``k`` and flip a floor. Dividing by a 0-d tensor on the
    operand's device takes the true-division kernel instead.
    """
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


class QuantizedActs(NamedTuple):
    """Unsigned activation codes plus dequantization parameters.

    x ~= scale * (codes - zero_point)
    """

    codes: torch.Tensor  # int32 in [0, 2**act_bits - 1]
    scale: torch.Tensor  # f32, broadcastable to x
    zero_point: torch.Tensor  # int32, broadcastable to x


class QuantizedWeights(NamedTuple):
    """Signed weight codes plus per-output-channel scale.

    w ~= scale * codes,  codes int32 in [-2**(B-1), 2**(B-1)-1]
    """

    codes: torch.Tensor  # int32, shape [..., K, N]
    scale: torch.Tensor  # f32, shape [..., 1, N] (per out-channel) or scalar


def percentile(
    x: torch.Tensor, qs: tuple[float, ...], dims: tuple[int, ...]
) -> list[torch.Tensor]:
    """Linear-interpolated percentiles of ``x`` over ``dims`` (keepdim).

    Mirrors ``jnp.percentile(x, q, method="linear")`` as XLA compiles
    it on the CPU, bit for bit. The position ``q / 100 * (n - 1)`` is
    float32, where XLA rewrites the division by the constant 100 into a
    product with f32(1/100) and folds that with the constant ``n - 1``:
    ``pos = f32(q) * f32(f32(1/100) * f32(n - 1))``. Then ``low =
    floor(pos)``, ``high = ceil(pos)``, ``w = pos - low`` and
    ``x[low] * (1 - w) + x[high] * w`` with one product fused (below).
    One sort serves every q (``torch.kthvalue``'s CPU quickselect
    degrades to quadratic time on sorted input). ``torch.quantile`` is
    not used: it interpolates in another order and refuses inputs above
    2**24 elements.
    """
    nd = x.ndim
    dims = tuple(sorted(d % nd for d in dims))
    keep = [d for d in range(nd) if d not in dims]
    moved = x.permute(*keep, *dims)
    lead = [x.shape[d] for d in keep]
    flat = moved.reshape(*lead, -1)
    srt = torch.sort(flat, dim=-1).values  # one sort serves every q
    n = flat.shape[-1]
    out_shape = [1 if d in dims else x.shape[d] for d in range(nd)]
    n_f = torch.tensor(float(n), dtype=torch.float32)
    scale = (torch.tensor(1.0, dtype=torch.float32) / 100.0) * (n_f - 1.0)
    results = []
    for q in qs:
        pos = torch.tensor(q, dtype=torch.float32) * scale
        low = torch.floor(pos)
        high = torch.ceil(pos)
        high_w = pos - low
        low_w = 1.0 - high_w
        lo_i = int(min(max(low.item(), 0.0), n - 1))
        hi_i = int(min(max(high.item(), 0.0), n - 1))
        lo_v = srt[..., lo_i].to(torch.float32)
        hi_v = srt[..., hi_i].to(torch.float32)
        # XLA's CPU backend contracts the final add with one product into
        # an FMA: with the high product for a scalar result, with the low
        # one when the result is a vector (per-token ranges). The float64
        # sum holds the fused product exactly; one rounding follows.
        lw, hw = low_w.to(x.device), high_w.to(x.device)
        if lo_v.numel() == 1:
            fused, (v, w) = lo_v * lw, (hi_v, hw)
        else:
            fused, (v, w) = hi_v * hw, (lo_v, lw)
        val = (v.to(torch.float64) * w.to(torch.float64)
               + fused.to(torch.float64)).to(torch.float32)
        results.append(val.to(x.dtype).reshape(out_shape))
    return results


def _range_stats(x, dims, clip_pct: float):
    """(lo, hi) of the quantization range over ``dims`` (keepdim);
    clip_pct < 1 uses percentile clipping (outlier-robust calibration)."""
    if clip_pct >= 1.0:
        return (torch.amin(x, dim=dims, keepdim=True),
                torch.amax(x, dim=dims, keepdim=True))
    q = clip_pct * 100.0
    hi, lo = percentile(x, (q, 100.0 - q), dims)
    return lo, hi


def quantize_acts(
    x: torch.Tensor,
    act_bits: int,
    *,
    symmetric: bool = False,
    per_token: bool = False,
    clip_pct: float = 1.0,
    eps: float = 1e-8,
) -> QuantizedActs:
    """Dynamic asymmetric (or unsigned-symmetric) activation quantization.

    symmetric=True assumes x >= 0 (post-ReLU, the paper's setting):
    codes = round(x / scale), zero_point = 0. Otherwise affine with a
    zero-point so signed tensors map onto the unsigned DAC codes.
    clip_pct in (0, 1] enables percentile-clipped calibration.
    """
    qmax = (1 << act_bits) - 1
    if per_token:
        dims = tuple(range(1, x.ndim))  # reduce all but the leading dim
    else:
        dims = tuple(range(x.ndim))
    if symmetric:
        _, hi = _range_stats(x, dims, clip_pct)
        scale = true_divide(torch.clamp_min(hi, eps), qmax)
        zp = torch.zeros(scale.shape, dtype=torch.int32, device=x.device)
        codes = torch.clamp(torch.round(x / scale), 0, qmax).to(torch.int32)
    else:
        lo, hi = _range_stats(x, dims, clip_pct)
        hi = torch.maximum(hi, lo + eps)
        scale = true_divide(hi - lo, qmax)
        zp = torch.clamp(torch.round(-lo / scale), 0, qmax).to(torch.int32)
        codes = torch.clamp(torch.round(x / scale) + zp, 0, qmax).to(
            torch.int32
        )
    return QuantizedActs(codes, scale, zp)


def quantize_weights(
    w: torch.Tensor,
    weight_bits: int,
    *,
    per_channel: bool = True,
    eps: float = 1e-8,
) -> QuantizedWeights:
    """Symmetric signed weight quantization (per output channel).

    w: [..., K, N]; the range reduces over K only, so leading batch dims
    each keep their own [..., 1, N] scales.
    """
    qmax = (1 << (weight_bits - 1)) - 1
    if per_channel:
        amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    else:
        amax = torch.amax(torch.abs(w))
    scale = true_divide(torch.clamp_min(amax, eps), qmax)
    codes = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(
        torch.int32
    )
    return QuantizedWeights(codes, scale)


def bitslice_weights(
    codes: torch.Tensor, weight_bits: int, *, dtype=torch.int32
) -> torch.Tensor:
    """Slice signed int codes into binary planes (two's complement).

    Returns 0/1 planes with shape [weight_bits, *codes.shape]; plane b
    holds bit b of the two's-complement representation, so
      codes = sum_b plane_sign(b) * 2**b * planes[b].
    Packed-plane bytes (uint8) slice the same way: their low
    ``weight_bits`` are the code bits.
    """
    mask = (1 << weight_bits) - 1
    unsigned = torch.bitwise_and(codes.to(torch.int32), mask)
    shifts = torch.arange(weight_bits, dtype=torch.int32, device=codes.device)
    shifts = shifts.reshape((weight_bits,) + (1,) * codes.ndim)
    planes = torch.bitwise_and(
        torch.bitwise_right_shift(unsigned.unsqueeze(0), shifts), 1
    )
    return planes.to(dtype)


def plane_signs(weight_bits: int, device=None) -> torch.Tensor:
    """Shift-add weighting per plane: [1, 2, 4, ..., -2**(B-1)] (int32)."""
    w = [1 << b for b in range(weight_bits)]
    w[-1] = -w[-1]
    return torch.tensor(w, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Spread-slot plane packing (the decode-shape operand form)
# ---------------------------------------------------------------------------

# f32 mantissa width: integer dot products stay exact below 2**24.
_F32_EXACT_BITS = 24


class SlotSpec(NamedTuple):
    """Geometry of the spread-slot packing at one operating point.

    ``stride`` is the per-plane field width (next power of two above the
    largest group pMAC), ``per_slot`` how many bit planes share one f32
    slot, ``n_slots`` how many slots cover weight_bits.
    """

    stride: int
    per_slot: int
    n_slots: int


def slot_spec(rows: int, act_bits: int, weight_bits: int) -> SlotSpec | None:
    """Packing geometry for spread slots, or None when infeasible."""
    # bound: pmac_max < stride
    pmac_max = rows * ((1 << act_bits) - 1)
    field_bits = max(1, pmac_max.bit_length())
    per_slot = _F32_EXACT_BITS // field_bits
    if per_slot < 1:
        return None
    per_slot = min(per_slot, weight_bits)
    n_slots = -(-weight_bits // per_slot)
    return SlotSpec(1 << field_bits, per_slot, n_slots)


def spread_slots(
    codes: torch.Tensor, rows: int, act_bits: int, weight_bits: int
) -> torch.Tensor:
    """[K, N] signed codes -> spread-slot planes [G, rows, S*N] f32.

    Each f32 element packs ``per_slot`` bit planes of one weight at
    stride ``stride`` so one grouped contraction yields every per-plane
    partial MAC in its own exact integer field. K is zero-padded to
    whole ``rows`` groups. Slot s occupies columns [s*N, (s+1)*N).
    """
    # bound: pmac_max * (stride**per_slot - 1) // (stride - 1) < 2**24
    spec = slot_spec(rows, act_bits, weight_bits)
    if spec is None:
        raise ValueError(
            f"spread slots infeasible: a {rows}-row group pMAC at "
            f"act_bits={act_bits} overflows the f32 mantissa"
        )
    k, n = codes.shape
    g = -(-k // rows)
    planes = bitslice_weights(codes, weight_bits, dtype=torch.int8)
    planes = torch.nn.functional.pad(planes, (0, 0, 0, g * rows - k))
    planes = planes.to(torch.float32)  # [B, G*rows, N]
    slots = []
    for s in range(spec.n_slots):
        lo = s * spec.per_slot
        acc = planes[lo]
        for j in range(1, min(spec.per_slot, weight_bits - lo)):
            acc = acc + planes[lo + j] * float(spec.stride ** j)
        slots.append(acc)
    out = torch.stack(slots, dim=1)  # [G*rows, S, N]
    return out.reshape(g, rows, spec.n_slots * n)


def unslice_weights(planes: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """Inverse of bitslice_weights (digital shift-add identity)."""
    signs = plane_signs(weight_bits, planes.device).reshape(
        (weight_bits,) + (1,) * (planes.ndim - 1)
    )
    return torch.sum(planes.to(torch.int32) * signs, dim=0).to(torch.int32)


# ---------------------------------------------------------------------------
# Straight-through estimators (QAT)
# ---------------------------------------------------------------------------


class _STERound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _STEClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward((x >= lo) & (x <= hi))
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return g * inside.to(g.dtype), None, None


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) forward, identity gradient."""
    return _STERound.apply(x)


def ste_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) forward; the gradient passes where lo <= x <= hi."""
    return _STEClip.apply(x, lo, hi)


def fake_quant_acts(
    x: torch.Tensor, cfg, *, symmetric: bool = False
) -> torch.Tensor:
    """Differentiable (STE) activation fake-quant to the DAC grid: the
    range is a constant of the gradient (``.detach()``)."""
    qmax = float(cfg.act_max)
    if symmetric:
        hi = torch.clamp_min(torch.amax(x).detach(), 1e-8)
        scale = true_divide(hi, qmax)
        codes = ste_clip(ste_round(x / scale), 0.0, qmax)
        return codes * scale
    hi = torch.amax(x).detach()
    lo = torch.amin(x).detach()
    hi = torch.maximum(hi, lo + 1e-8)
    scale = true_divide(hi - lo, qmax)
    zp = torch.round(-lo / scale)
    codes = ste_clip(ste_round(x / scale) + zp, 0.0, qmax)
    return (codes - zp) * scale


def fake_quant_weights(w: torch.Tensor, cfg) -> torch.Tensor:
    """Differentiable (STE) weight fake-quant to the signed grid, with the
    range reduced over K only (dim -2), as ``quantize_weights``: QAT trains
    against the per-[..., 1, N] scales the planned path deploys."""
    qmax = float((1 << (cfg.weight_bits - 1)) - 1)
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True).detach()
    scale = true_divide(torch.clamp_min(amax, 1e-8), qmax)
    codes = ste_clip(ste_round(w / scale), -qmax - 1.0, qmax)
    return codes * scale
