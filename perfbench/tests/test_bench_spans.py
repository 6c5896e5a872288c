"""The idle arithmetic under the program's spans (``perfbench/spans.py``)
and its readers, on built traces."""

import types

import pytest

from perfbench import spans
from perfbench.metrics import (device_idle, dispatch_idle, im2col_idle,
                               model_idle, periphery_idle)
from perfbench.trace import Trace

P = "repro_torch."
READERS = [periphery_idle, dispatch_idle, model_idle, im2col_idle]


def _rec(trace):
    return types.SimpleNamespace(trace=trace)


def test_union_and_minus():
    assert spans.union([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    a = [(0, 10), (11, 15), (20, 22)]
    b = [(2, 3), (5, 12), (20, 22)]
    assert spans.minus(a, b) == [(0, 2), (3, 5), (12, 15)]
    assert spans.minus(a, []) == a
    assert spans.minus([], b) == []


def test_idle_counts_the_union_once_and_only_off_the_device():
    # Nested spans of one set count once: 0-100 with 20-40 inside it.
    # The device runs 10-30 and 90-120: idle 0-10, 30-90.
    t = Trace(window_s=200e-9, calls=1,
              device=[(10, 30, "k"), (90, 120, "k")],
              host=[(0, 100, P + "a"), (20, 40, P + "a"),
                    (150, 160, P + "b"), (0, 100, "aten::mul")])
    assert spans.idle_ns(t, (P + "a",)) == 70
    assert spans.idle_ns(t, (P + "a", P + "b")) == 80
    assert spans.idle_ns(t, (P + "c",)) is None
    assert spans.idle_share(_rec(t), (P + "a",)) == pytest.approx(35.0)


def _pass_trace():
    """A decode step 0-1000 with one macro call at 100-400 (quantize
    100-200, macro 200-300, epilogue 300-400) and an im2col-free model
    between; the device runs 250-350 and 600-700."""
    host = [(0, 1000, P + "serve.decode_step"),
            (100, 200, P + "engine.quantize"),
            (120, 150, "aten::mul"),
            (200, 300, P + "engine.macro"),
            (300, 400, P + "engine.epilogue")]
    device = [(250, 350, "plane_mma_kernel"), (600, 700, "elementwise")]
    return Trace(window_s=1000e-9, calls=1, device=device, host=host)


def test_model_idle_leaves_out_the_engine_spans_inside_a_pass():
    rec = _rec(_pass_trace())
    # The pass less the engine: 0-100 and 400-1000, less the device's
    # 600-700: 600 ns of 1000.
    assert model_idle.read(rec) == pytest.approx(60.0)
    # Quantize 100-200 idle, epilogue 350-400 idle: 150 ns.
    assert periphery_idle.read(rec) == pytest.approx(15.0)
    # Macro 200-250 idle.
    assert dispatch_idle.read(rec) == pytest.approx(5.0)
    assert im2col_idle.read(rec) is None


def test_shares_add_up_to_at_most_device_idle_when_spans_cover_the_window():
    rec = _rec(_pass_trace())
    parts = (periphery_idle.read(rec) + dispatch_idle.read(rec)
             + model_idle.read(rec))
    assert parts == pytest.approx(device_idle.read(rec))
    assert parts <= device_idle.read(rec) + 1e-9
    # A gap outside every pass is device idle that no layer claims.
    t = _pass_trace()
    t.window_s = 1200e-9
    rec = _rec(t)
    parts = (periphery_idle.read(rec) + dispatch_idle.read(rec)
             + model_idle.read(rec))
    assert parts < device_idle.read(rec)


def test_resnet_im2col_inside_a_forward():
    host = [(0, 500, P + "resnet.forward"), (10, 60, P + "resnet.im2col"),
            (10, 60, "aten::im2col"), (100, 130, P + "engine.quantize"),
            (130, 160, P + "engine.macro"), (160, 200, P + "engine.epilogue")]
    t = Trace(window_s=1000e-9, calls=1, device=[(40, 140, "im2col")],
              host=host)
    rec = _rec(t)
    assert im2col_idle.read(rec) == pytest.approx(3.0)  # 10-40
    # Forward less the engine (0-100, 200-500) less 40-100 on the device.
    assert model_idle.read(rec) == pytest.approx(34.0)
    # Quantize 100-130 runs beside the device; the epilogue 160-200 not.
    assert periphery_idle.read(rec) == pytest.approx(4.0)
    assert dispatch_idle.read(rec) == pytest.approx(2.0)  # 140-160


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_readers_return_none_without_program_spans(reader):
    # What a program without spans gives: host ops only.
    t = Trace(window_s=1000e-9, calls=1, device=[(0, 100, "k")],
              host=[(0, 500, "aten::im2col"), (600, 700, "cudaLaunchKernel")])
    assert reader.read(_rec(t)) is None
    assert reader.read(_rec(None)) is None
