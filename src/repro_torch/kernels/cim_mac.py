"""The P-8T GPQ matmul: the hand-written Hopper kernel and its plain version.

``gpq_matmul`` computes what the reference's Pallas kernel
``repro/kernels/cim_mac.py::gpq_matmul`` computes: for activation codes
x [M, K] and weight bytes w [K, N] (int8 signed codes or a plan's uint8
packed-plane bytes),

  pMAC[m, g, b, n] = sum_{k in group g} x[m, k] * bit_b(w[k, n])
  code             = clip(floor(pMAC / adc_step + 1/2 * nearest),
                          0, adc_codes - 1)
  out[m, n]        = sum_g sum_b s_b * 2^b * code * adc_step

with s_b = -1 on the MSB plane. On a CUDA tensor it launches the kernel
of ``csrc/gpq_matmul.cu`` (built on first use by ``kernels.build``) or
raises; on a CPU tensor it runs :func:`gpq_matmul_plain`, the same
function in plain PyTorch ops, which is also what the kernel is held to
on the card. There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches by kernel name; it moves only where
a kernel is launched.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec
from repro_torch.core.quant import true_divide
from repro_torch.kernels import build

LAUNCHES: collections.Counter[str] = collections.Counter()


class DepthGuardError(ValueError):
    """K is past the reference's exact-accumulation depth."""


def _depth_guard(k: int, spec: MacroSpec) -> None:
    """The reference's f32 exact-accumulation bound, kept as the contract.

    The kernel accumulates in int32 and could go deeper; it raises where
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


def _unpacked_planes(w: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """[K, N] codes or packed bytes -> [K, B, N] 0/1 planes (f32)."""
    mask = (1 << weight_bits) - 1
    u = torch.bitwise_and(w.to(torch.int32), mask)
    shifts = torch.arange(weight_bits, dtype=torch.int32, device=w.device)
    planes = torch.bitwise_and(
        torch.bitwise_right_shift(u[:, None, :], shifts[None, :, None]), 1
    )
    return planes.to(torch.float32)


def gpq_matmul_plain(
    x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig | MacroSpec
) -> torch.Tensor:
    """The GPQ matmul in plain PyTorch ops: the kernel's reference version.

    Follows the Pallas kernel's float arithmetic: f32 group pMACs, codes
    from ``floor(pMAC / adc_step + half)`` in f32, dequantized codes
    summed with the plane signs. One [G, M, B*N] contraction, so its
    memory grows with G * M * B * N.
    """
    spec = MacroSpec.from_config(cfg)
    m, k = x_codes.shape
    if w_codes.shape[0] != k:
        raise ValueError(f"K mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    _depth_guard(k, spec)
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
    # Group pMACs <= rows * act_max are exact in f32 (also under TF32,
    # whose 11-bit significand holds codes and 0/1 planes exactly).
    pmac = torch.bmm(xg, pe)  # [G, M, B*N]
    half = 0.5 if spec.adc_mode == "nearest" else 0.0
    code = torch.clamp(
        torch.floor(true_divide(pmac, spec.adc_step) + half), 0, spec.adc_codes - 1
    )
    signs = [float(1 << i) for i in range(b)]
    signs[-1] = -signs[-1]
    sign_t = torch.tensor(signs, dtype=torch.float32, device=x_codes.device)
    deq = code.reshape(g, m, b, n) * spec.adc_step
    return (deq * sign_t[:, None]).sum(dim=(0, 2))


def _check_cuda_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"gpq_matmul needs x and w on one CUDA device; got {x.device} "
            f"and {w.device}"
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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not getattr(lib, "_gpq_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpq_matmul_launch.argtypes = [
            p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p,
        ]
        lib.gpq_matmul_launch.restype = i
        lib.gpq_error_string.argtypes = [i]
        lib.gpq_error_string.restype = ctypes.c_char_p
        lib._gpq_bound = True
    return lib


def gpq_matmul(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
) -> torch.Tensor:
    """GPQ matmul [M, K] x [K, N] -> [M, N] float32.

    CPU tensors run :func:`gpq_matmul_plain`. CUDA tensors launch the
    hand-written kernel on the current stream, without synchronising;
    anything the kernel does not take (dtype, layout, device) raises.
    Both raise ``ValueError`` past the reference's depth guard.
    """
    spec = MacroSpec.from_config(cfg)
    if x_codes.device.type == "cpu" and w_codes.device.type == "cpu":
        return gpq_matmul_plain(x_codes, w_codes, spec)
    _check_cuda_operands(x_codes, w_codes)
    m, k = x_codes.shape
    n = w_codes.shape[1]
    _depth_guard(k, spec)
    if spec.weight_bits > 8:
        raise ValueError("the kernel takes weight_bits <= 8 (one byte each)")
    out = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _bind(build.library("gpq_matmul"))
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    rc = lib.gpq_matmul_launch(
        x_codes.data_ptr(), w_codes.data_ptr(), out.data_ptr(),
        m, k, n, spec.rows_active, spec.weight_bits, spec.adc_bits,
        spec.threshold, spec.adc_codes, int(spec.adc_mode == "nearest"),
        float(spec.adc_step), stream,
    )
    if rc != 0:
        msg = lib.gpq_error_string(rc).decode()
        raise RuntimeError(f"gpq_matmul launch failed: {msg} ({rc})")
    LAUNCHES["gpq_matmul"] += 1
    return out
