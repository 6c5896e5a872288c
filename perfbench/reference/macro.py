"""The P-8T macro's matmul in plain PyTorch: the benchmark's yardstick.

Written from the paper's datapath (4-bit DAC inputs, 8-bit bit-sliced
weights, 16-row groups on one accumulation bit-line, a floor flash ADC
below a cutoff threshold, digital shift-add), not from the program: it
imports nothing of it and plans every weight again from the raw weights.

  quantize_weights(w, bits)            -> (codes [K, N] int32, scale [1, N])
  quantize_acts(x, bits, symmetric=, clip_pct=)
                                       -> (codes [M, K] int32, scale, zp)
  macro_int(x_codes, w_codes, op)      -> [M, N] float32 macro units
  linear(x, w, op, ...)                -> the whole macro layer, dequantized

Arithmetic follows the configuration's dtypes: the activation quantizer
runs in the activation's dtype (bfloat16 for an LM, float32 for the
ResNet); weight quantization and the dequant epilogue in float32. Every
division is IEEE division, rounded once. The macro's sum of dequantized
codes is an integer below 2**24 at every shape used here, so it is exact
in float32 in any order.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One macro operating point (the configuration file's ``cim``)."""

    rows_active: int = 16
    act_bits: int = 4
    weight_bits: int = 8
    adc_bits: int = 4
    cutoff: float = 0.5
    adc_mode: str = "floor"

    @classmethod
    def from_json(cls, d: dict) -> "OperatingPoint":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    @property
    def threshold(self) -> int:
        """The cutoff in pMAC units: (1 - cutoff) * 2**q, q the bits an
        exact readout of rows * act_max needs."""
        q = max(1, math.ceil(math.log2(
            self.rows_active * ((1 << self.act_bits) - 1) + 1)))
        return max(1, int(round((1.0 - self.cutoff) * (1 << q))))

    @property
    def adc_step(self) -> float:
        return self.threshold / (1 << self.adc_bits)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as IEEE division in a's dtype (a Python divisor on CUDA
    would be a product with its reciprocal)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_weights(w: torch.Tensor, bits: int):
    """Symmetric per-output-channel weight codes of w [K, N], in float32."""
    w = w.to(torch.float32)
    qmax = (1 << (bits - 1)) - 1
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scale = true_div(torch.clamp_min(amax, 1e-8), qmax)
    codes = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    return codes.to(torch.int32), scale


def percentile_scalar(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of x (linear interpolation), as the
    paper's reference package computes it in float32: the position
    ``f32(q) * (f32(1/100) * f32(n - 1))``, and the interpolation with the
    low product rounded and the high one fused into the sum."""
    flat = torch.sort(x.reshape(-1)).values
    n = flat.numel()
    one = torch.tensor(1.0, dtype=torch.float32)
    pos = torch.tensor(q, dtype=torch.float32) * (
        (one / 100.0) * torch.tensor(float(n - 1), dtype=torch.float32))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_v = flat[int(min(max(low.item(), 0.0), n - 1))].to(torch.float32)
    hi_v = flat[int(min(max(high.item(), 0.0), n - 1))].to(torch.float32)
    fused = lo_v * lw.to(x.device)
    val = (hi_v.double() * hw.double().to(x.device) + fused.double())
    return val.to(torch.float32).to(x.dtype)


def quantize_acts(x: torch.Tensor, bits: int, *, symmetric: bool,
                  clip_pct: float):
    """Per-tensor activation codes in [0, 2**bits) of x [M, K], every op
    in x's dtype: (codes int32, scale, zero point int32)."""
    qmax = (1 << bits) - 1
    if clip_pct < 1.0:
        hi = percentile_scalar(x, clip_pct * 100.0).reshape(1, 1)
    else:
        hi = torch.amax(x).reshape(1, 1)
    if symmetric:
        scale = true_div(torch.clamp_min(hi, 1e-8), qmax)
        zp = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
        codes = torch.clamp(torch.round(x / scale), 0, qmax)
    else:
        if clip_pct < 1.0:
            lo = percentile_scalar(x, 100.0 - clip_pct * 100.0)
        else:
            lo = torch.amin(x)
        hi = torch.maximum(hi, lo.reshape(1, 1) + 1e-8)
        lo = lo.reshape(1, 1)
        scale = true_div(hi - lo, qmax)
        zp = torch.clamp(torch.round(-lo / scale), 0, qmax).to(torch.int32)
        codes = torch.clamp(torch.round(x / scale) + zp, 0, qmax)
    return codes.to(torch.int32), scale, zp


# Largest [G, rows-block, N] pMAC tile held at once (float32 elements).
_TILE_ELEMS = 1 << 28


def macro_int(x_codes: torch.Tensor, w_codes: torch.Tensor,
              op: OperatingPoint) -> torch.Tensor:
    """sum_g sum_b s_b 2^b adc_step * ADC(pMAC[m, g, b, n]) [M, N] f32.

    pMAC[m, g, b, n] = sum over the rows k of group g of
    x[m, k] * bit_b(w[k, n]) (two's complement bits; s_b = -1 on the MSB
    plane); ADC(p) = clip(floor(p / adc_step [+ 1/2 if nearest]), 0,
    2**adc_bits - 1). One plane at a time, in blocks of rows.
    """
    m, k = x_codes.shape
    n = w_codes.shape[1]
    rows = op.rows_active
    g = -(-k // rows)
    xg = F.pad(x_codes.to(torch.float32), (0, g * rows - k))
    xg = xg.reshape(m, g, rows).transpose(0, 1).contiguous()  # [G, M, rows]
    unsigned = torch.bitwise_and(w_codes.to(torch.int32),
                                 (1 << op.weight_bits) - 1)
    step = torch.full((), op.adc_step, dtype=torch.float32,
                      device=x_codes.device)
    half = 0.5 if op.adc_mode == "nearest" else 0.0
    top = (1 << op.adc_bits) - 1
    out = torch.zeros((m, n), dtype=torch.float32, device=x_codes.device)
    mb = max(1, _TILE_ELEMS // (g * n))
    for b in range(op.weight_bits):
        plane = torch.bitwise_and(torch.bitwise_right_shift(unsigned, b), 1)
        plane = F.pad(plane.to(torch.float32), (0, 0, 0, g * rows - k))
        plane = plane.reshape(g, rows, n)
        weight = float(1 << b) * op.adc_step
        if b == op.weight_bits - 1:
            weight = -weight
        for r0 in range(0, m, mb):
            pmac = torch.bmm(xg[:, r0:r0 + mb], plane)  # [G, mb, N]
            code = torch.clamp(torch.floor(pmac / step + half), 0, top)
            out[r0:r0 + mb] += code.sum(dim=0) * weight
    return out


@dataclasses.dataclass(frozen=True)
class PlannedLinear:
    """The reference's own plan of one weight: its codes and scales."""

    codes: torch.Tensor  # [K, N] int32
    scale: torch.Tensor  # [1, N] f32
    colsum: torch.Tensor  # [1, N] f32


def plan(w: torch.Tensor, op: OperatingPoint) -> PlannedLinear:
    codes, scale = quantize_weights(w, op.weight_bits)
    colsum = torch.sum(codes, dim=0, keepdim=True).to(torch.float32)
    return PlannedLinear(codes, scale, colsum)


def linear(x: torch.Tensor, p: PlannedLinear, op: OperatingPoint, *,
           symmetric: bool, clip_pct: float) -> torch.Tensor:
    """One macro layer on x [..., K] -> [..., N] in x's dtype: quantize,
    the macro, then dequantize with the zero-point column correction."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    codes, a_scale, zp = quantize_acts(x2, op.act_bits, symmetric=symmetric,
                                       clip_pct=clip_pct)
    y = macro_int(codes, p.codes, op)
    y = y - zp.to(torch.float32) * p.colsum
    y = y * a_scale * p.scale
    return y.reshape(*lead, -1).to(x.dtype)
