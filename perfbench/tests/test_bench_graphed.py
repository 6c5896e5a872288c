"""``graphed_steps.decode`` (``perfbench/metrics/graphed_steps.py``) on
built traces: the share of decode steps that replayed the engine's CUDA
graph."""

import types

import pytest

from perfbench.metrics import graphed_steps
from perfbench.trace import Trace

P = "repro_torch."


def _rec(host):
    return types.SimpleNamespace(trace=Trace(
        window_s=1000e-9, calls=1, device=[(0, 100, "k")], host=host))


def test_every_step_replayed_reads_100():
    host = [(0, 900, P + "serve.generate"), (0, 300, P + "serve.prefill")]
    for s in (300, 500, 700):
        host += [(s, s + 200, P + "serve.decode_step"),
                 (s + 10, s + 190, P + "serve.decode_graph")]
    assert graphed_steps.read(_rec(host)) == pytest.approx(100.0)


def test_eager_steps_read_0():
    host = [(0, 300, P + "serve.prefill"),
            (300, 500, P + "serve.decode_step"),
            (310, 320, P + "engine.macro"),
            (500, 700, P + "serve.decode_step")]
    assert graphed_steps.read(_rec(host)) == 0.0


def test_a_captured_step_is_not_a_replay():
    # The first step of a graphed engine runs eagerly and captures.
    host = [(0, 200, P + "serve.decode_step"),
            (0, 200, P + "serve.decode_capture"),
            (200, 300, P + "serve.decode_step"),
            (210, 290, P + "serve.decode_graph")]
    assert graphed_steps.read(_rec(host)) == pytest.approx(50.0)


@pytest.mark.parametrize("host", [
    [(0, 500, "aten::im2col"), (600, 700, "cudaLaunchKernel")],
    [(0, 500, P + "resnet.forward"), (0, 400, P + "serve.prefill")],
], ids=["no-spans", "no-decode-step"])
def test_returns_none_without_decode_steps(host):
    assert graphed_steps.read(_rec(host)) is None
    assert graphed_steps.read(types.SimpleNamespace(trace=None)) is None
