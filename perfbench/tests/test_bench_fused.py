"""``fused_periphery.*`` (``perfbench/metrics/fused_periphery.py``) on
built traces: the share of the engine's quantizers that ran as its
kernels."""

import types

import pytest

from perfbench.metrics import fused_periphery
from perfbench.trace import Trace

P = "repro_torch."


def _rec(host):
    return types.SimpleNamespace(trace=Trace(
        window_s=1000e-9, calls=1, device=[(0, 100, "k")], host=host))


def _macro_call(s, fused):
    """One macro call's engine spans from host time ``s``."""
    host = [(s, s + 30, P + "engine.quantize")]
    if fused:
        host.append((s + 10, s + 25, P + "engine.quantize_kernel"))
    return host + [(s + 30, s + 60, P + "engine.macro"),
                   (s + 60, s + 90, P + "engine.epilogue")]


def test_every_quantizer_fused_reads_100():
    host = [(0, 1000, P + "serve.prefill")]
    for s in range(0, 900, 100):
        host += _macro_call(s, fused=True)
    assert fused_periphery.read(_rec(host)) == pytest.approx(100.0)


def test_aten_quantizers_read_0():
    host = [(0, 1000, P + "resnet.forward")]
    for s in range(0, 900, 100):
        host += _macro_call(s, fused=False)
    assert fused_periphery.read(_rec(host)) == 0.0


def test_a_share_of_the_quantizers():
    host = _macro_call(0, True) + _macro_call(100, False) + _macro_call(
        200, False) + _macro_call(300, True)
    assert fused_periphery.read(_rec(host)) == pytest.approx(50.0)


@pytest.mark.parametrize("host", [
    [(0, 500, "aten::amin"), (600, 700, "cudaLaunchKernel")],
    [(0, 500, P + "serve.decode_step"), (0, 400, P + "serve.decode_graph")],
], ids=["no-spans", "replayed-step"])
def test_returns_none_without_quantizers(host):
    assert fused_periphery.read(_rec(host)) is None
    assert fused_periphery.read(types.SimpleNamespace(trace=None)) is None
