"""The trace's reductions and the per-layer readers on a built trace."""

import types

import pytest

from perfbench import harness, peaks
from perfbench.metrics import (device_idle, launches_per_step,
                               macro_roofline, step_mfu)
from perfbench.trace import Trace

B1 = ("void gpq::plane_mma_kernel<16, 1, gpq::BitPlanes, "
      "(anonymous namespace)::FlashShift2>(int const*, unsigned char const*)")


def _trace():
    device = [(0, 100, B1), (50, 150, "im2col_kernel"),
              (200, 260, "Memcpy DtoH (Device -> Pinned)"), (400, 500, B1)]
    host = [(0, 1000, "aten::conv"), (150, 220, "aten::sort"),
            (262, 398, "cudaLaunchKernel")]
    return Trace(window_s=1000e-9, calls=2, device=device, host=host)


def test_reductions():
    t = _trace()
    assert t.busy_s() == pytest.approx(310e-9)
    assert len(t.kernels()) == 3
    assert t.device_ops()[0] == [B1, pytest.approx(200e-9)]
    # Gaps 150-200 (middle 175 in aten::sort) and 260-400 (middle 330 in
    # cudaLaunchKernel inside aten::conv).
    assert t.idle_gaps() == [["aten::conv", pytest.approx(140e-9)],
                             ["aten::sort", pytest.approx(50e-9)]]


def _record(trace):
    cell = types.SimpleNamespace(
        cfg={"cim": {"act_bits": 4, "weight_bits": 8}}, steps_per_call=1,
        model_macs=lambda: 10**9,
        macro_products=lambda: [dict(m=64, k=16, n=16, in_elems=64 * 16,
                                     out_bytes=4)])
    return harness.Record(cell=cell, calls=5, window_s=0.5, trace=trace)


def test_readers():
    rec = _record(_trace())
    assert device_idle.read(rec) == pytest.approx(69.0)
    assert launches_per_step.read(rec) == pytest.approx(1.5)
    bound = peaks.macro_bound_s(rec.cell.macro_products()[0], 4, 8)
    assert macro_roofline.read(rec) == pytest.approx(
        100 * 2 * bound / 200e-9)
    assert step_mfu.read(rec) == pytest.approx(
        100 * 2e9 * 5 / 0.5 / 1979e12)


def test_readers_find_nothing_without_a_trace_or_the_kernel():
    rec = _record(None)
    assert device_idle.read(rec) is None
    assert macro_roofline.read(rec) is None
    assert launches_per_step.read(rec) is None
    t = _trace()
    t.device = [ev for ev in t.device if ev[2] != B1]
    assert macro_roofline.read(_record(t)) is None


def test_the_b1_pattern_takes_b1_only():
    pat = macro_roofline.B1_KERNEL
    assert pat.search(B1)
    assert pat.search("_ZN3gpq16plane_mma_kernelILi32ELi1ENS_9BitPlanesEN"
                      "12_GLOBAL__N_111FlashShift2EEEvPKiPKhPfiiiiiiT2_f")
    assert not pat.search(B1.replace("BitPlanes", "SignedPlane"))
    assert not pat.search(B1.replace("FlashShift2", "SarSearch"))
