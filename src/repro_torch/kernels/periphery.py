"""The macro call's digital periphery on the card: the activation quantizer
and the dequantizing epilogue as hand-written kernels, and their plain
versions.

``core.engine.quantized_backend`` runs, around every macro call,

  quantize_acts      quant.quantize_acts over x [M, K]: the per-tensor
                     range (amin/amax, or quant.percentile's when
                     ``clip_pct < 1``), the scale and zero point, the
                     int32 codes
  dequant_epilogue   y = ((y_int - f32(zp) * colsum) * f32(scale)) *
                     plan.scale over the macro's float32 output, cast to
                     the activation dtype (float32 under 'fp' mode)

Eagerly that is about 23 ATen launches a call; here it is the kernels of
``csrc/periphery.cu``: ``act_quant`` alone up to ``SINGLE_BLOCK_MAX``
elements (one block ranges and codes x), ``act_range`` then
``act_quant`` above it (partial ranges per block, then every block
reduces them and codes its slice), and ``dequant_epilogue``. Where the
range comes from ``quant.percentile`` (``clip_pct < 1``), the sort stays
in PyTorch and ``act_quant`` reads its result. Each kernel computes what
the ATen ops compute, bit for bit; the ``*_plain`` versions take the
kernels' ops in PyTorch, float32 rounded to the activation dtype after
each op, and are what the kernels are held to on the card.

On a CUDA tensor a wrapper launches its kernels (``build.launch``, each
counted in ``build.LAUNCHES`` by kernel name) on the current stream
without synchronising; on a CPU tensor it runs the plain version. The
engine takes this path only where :func:`takes` holds; everything else
(the CPU, a dtype the kernels do not take, autograd through the scales)
keeps the ATen ops.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core import quant
from repro_torch.kernels import build

SOURCE = "periphery"
# Activation dtypes the kernels take, by the code csrc/periphery.cu reads.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 512  # csrc/periphery.cu kThreads
MAX_BLOCKS = 4 * 132  # four 512-thread blocks on each of an H100's SMs
# Up to this many elements one block ranges and codes x in one launch;
# above it, two launches over the grid. On an H100 the single block takes
# 3.9 us of device time at 4096 bfloat16 elements against the two
# launches' 4.8, 5.4 against 4.8 at 8192 (where it still saves the second
# launch's host time) and 8.3 against 4.8 at 16384
# (scripts/periphery_time.py; PERF.md, the periphery rows).
SINGLE_BLOCK_MAX = 1 << 13
# csrc/periphery.cu RangeSrc
_RANGE_SELF, _RANGE_PARTIALS, _RANGE_GIVEN = 0, 1, 2


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def takes(x2: torch.Tensor, plan) -> bool:
    """Whether a macro call's periphery runs as the kernels: x2 on a CUDA
    device, non-empty, in a dtype they take, with nothing for autograd to
    record (``engine.matmul`` without ``ste`` differentiates through the
    activation's range and the plan's scales)."""
    return (
        _on_card(x2)
        and x2.dtype in DTYPES
        and x2.numel() > 0
        and not (torch.is_grad_enabled()
                 and (x2.requires_grad or plan.scale.requires_grad))
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 result rounded to ``dtype`` and read back: what one ATen
    op of that dtype stores (its opmath is float32)."""
    return t.to(dtype).to(torch.float32)


def quantize_acts_plain(
    x: torch.Tensor,
    act_bits: int,
    *,
    symmetric: bool = False,
    clip_pct: float = 1.0,
    eps: float = 1e-8,
) -> quant.QuantizedActs:
    """``act_quant`` in plain PyTorch ops, on x [M, K]: each of
    ``quant.quantize_acts``' ops in float32, rounded to x's dtype after
    it. The divisor ``qmax`` is a value of x's dtype (``true_divide``'s
    0-d tensor), the clamp's bound a float32 (ATen's opmath scalar). The
    one op that is ATen's own is ``lo + eps``: each device adds a Python
    scalar its own way (CUDA in float32, the CPU after rounding it to the
    dtype)."""
    dt, f32 = x.dtype, torch.float32
    qmax = (1 << act_bits) - 1
    qdiv = _rounded(torch.full((), qmax, dtype=f32, device=x.device), dt)
    lo, hi = (v.to(f32) for v in quant._range_stats(x, (0, 1), clip_pct))
    xf = x.to(f32)
    if symmetric:
        scale = _rounded(_rounded(torch.clamp_min(hi, eps), dt) / qdiv, dt)
        zp = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
        v = torch.round(_rounded(xf / scale, dt))
    else:
        hi = torch.maximum(hi, (lo.to(dt) + eps).to(f32))
        scale = _rounded(_rounded(hi - lo, dt) / qdiv, dt)
        z = torch.round(_rounded(-lo / scale, dt))
        zp = _rounded(torch.clamp(z, 0, qmax), dt).to(torch.int32)
        v = _rounded(torch.round(_rounded(xf / scale, dt)) + zp.to(f32), dt)
    codes = _rounded(torch.clamp(v, 0, qmax), dt).to(torch.int32)
    return quant.QuantizedActs(codes, scale.to(dt), zp)


def dequant_epilogue_plain(
    y_int: torch.Tensor,
    qa: quant.QuantizedActs,
    colsum: torch.Tensor,
    wscale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """``dequant_epilogue`` in plain PyTorch ops, and the engine's epilogue
    off the kernels: one rounding per op, ((y_int - f32(zp) * colsum) *
    scale) * wscale, then the cast; float32 throughout for the kernels'
    dtypes (a float64 scale promotes the product)."""
    n = y_int.shape[-1]
    correction = qa.zero_point.to(torch.float32) * colsum.reshape(1, n)
    y = (y_int - correction) * qa.scale
    return (y * wscale.reshape(1, n)).to(out_dtype)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

_P, _I, _LL, _F, _S = (build.PTR, build.INT, build.INT64, build.FLOAT,
                       build.STREAM)
_ARGTYPES = {
    "act_range": [_P, _I, _LL, _I, _P, _S],
    "act_quant": [_P, _I, _LL, _I, _I, _P, _I, _P, _P, _F, _F, _I, _P, _P,
                  _P, _S],
    "dequant_epilogue": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _S],
}
build.declare(SOURCE, _ARGTYPES)


def grid(units: int) -> int:
    """Blocks of THREADS threads for ``units`` four-element units, at most
    MAX_BLOCKS (the threads then stride)."""
    return max(1, min(-(-units // THREADS), MAX_BLOCKS))


def _check(x: torch.Tensor, act_bits: int) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"the periphery kernels take {sorted(map(str, DTYPES))}"
                        f"; got {x.dtype}")
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f"need a non-empty x [M, K]; got {tuple(x.shape)}")
    if not 1 <= act_bits <= 24:  # qmax and the codes exact in float32
        raise ValueError(f"act_bits must be in [1, 24]; got {act_bits}")


def quantize_acts(
    x: torch.Tensor,
    act_bits: int,
    *,
    symmetric: bool = False,
    clip_pct: float = 1.0,
    eps: float = 1e-8,
) -> quant.QuantizedActs:
    """``quant.quantize_acts`` of x [M, K] per tensor: codes int32 [M, K],
    scale [1, 1] in x's dtype, zero point int32 [1, 1]. CPU tensors run
    :func:`quantize_acts_plain`; CUDA tensors launch ``act_quant`` (after
    ``act_range`` above SINGLE_BLOCK_MAX elements, with no percentile)
    inside a ``repro_torch.engine.quantize_kernel`` span."""
    _check(x, act_bits)
    if not _on_card(x):
        return quantize_acts_plain(x, act_bits, symmetric=symmetric,
                                   clip_pct=clip_pct, eps=eps)
    x = x.contiguous()
    n = x.numel()
    dtype = DTYPES[x.dtype]
    given = clip_pct < 1.0
    lo = hi = None
    if given:
        lo, hi = quant._range_stats(x, (0, 1), clip_pct)
    codes = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    scale = torch.empty((1, 1), dtype=x.dtype, device=x.device)
    zp = torch.empty((1, 1), dtype=torch.int32, device=x.device)
    stream = build.stream(x)
    with tracing.span("repro_torch.engine.quantize_kernel"):
        partials = None
        if given:
            src, blocks = _RANGE_GIVEN, grid(-(-n // 4))
        elif n <= SINGLE_BLOCK_MAX:
            src, blocks = _RANGE_SELF, 1
        else:
            src, blocks = _RANGE_PARTIALS, grid(-(-n // 4))
            partials = torch.empty(2 * blocks, dtype=torch.float32,
                                   device=x.device)
            build.launch(SOURCE, "act_range", x.data_ptr(), dtype, n,
                         blocks, partials.data_ptr(), stream)
        build.launch(SOURCE, "act_quant", x.data_ptr(), dtype, n, blocks,
                     src, None if partials is None else partials.data_ptr(),
                     0 if partials is None else blocks,
                     None if lo is None else lo.data_ptr(),
                     None if hi is None else hi.data_ptr(),
                     float((1 << act_bits) - 1), eps, int(symmetric),
                     codes.data_ptr(), scale.data_ptr(), zp.data_ptr(),
                     stream)
    return quant.QuantizedActs(codes, scale, zp)


def dequant_epilogue(
    y_int: torch.Tensor,
    qa: quant.QuantizedActs,
    colsum: torch.Tensor,
    wscale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The engine's epilogue over the macro's float32 output y_int [M, N]
    with the per-tensor ``qa`` and the plan's [.., N] float32 ``colsum``
    and ``wscale``: [M, N] in ``out_dtype`` (qa's scale dtype, or
    float32). CPU tensors run :func:`dequant_epilogue_plain`; CUDA tensors
    launch ``dequant_epilogue``."""
    m, n = y_int.shape
    act = qa.scale.dtype
    if y_int.dtype != torch.float32 or act not in DTYPES:
        raise TypeError(f"need a float32 y_int and a scale in "
                        f"{sorted(map(str, DTYPES))}; got {y_int.dtype}, "
                        f"{act}")
    if out_dtype not in (act, torch.float32):
        raise TypeError(f"out_dtype must be {act} or float32; got {out_dtype}")
    for name, t in (("colsum", colsum), ("wscale", wscale)):
        if t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"{name} must hold {n} float32 values; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if qa.scale.numel() != 1 or qa.zero_point.numel() != 1:
        raise ValueError("the epilogue takes a per-tensor scale and zero "
                         "point")
    if not _on_card(y_int):
        return dequant_epilogue_plain(y_int, qa, colsum, wscale, out_dtype)
    y_int, colsum, wscale = (t.contiguous() for t in (y_int, colsum, wscale))
    out = torch.empty((m, n), dtype=out_dtype, device=y_int.device)
    if m == 0 or n == 0:
        return out
    units = m * n // 4 if n % 4 == 0 else m * n
    build.launch(SOURCE, "dequant_epilogue", y_int.data_ptr(),
                 colsum.data_ptr(), wscale.data_ptr(), qa.scale.data_ptr(),
                 qa.zero_point.data_ptr(), out.data_ptr(), DTYPES[act],
                 DTYPES[out_dtype], m, n, grid(units), build.stream(y_int))
    return out
