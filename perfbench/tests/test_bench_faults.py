"""The check decides ``correct``: a whole run at a small size on the CPU
(the harness's look for a card skipped) comes out correct, and with the
timed path broken underneath, or the control in the program's place,
comes out not correct."""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, probe
from perfbench.tests.small import run_small, small_spec

CELLS = ["resnet20-cifar.eval-b256", "qwen2-0.5b.decode-b4",
         "qwen2-0.5b.prefill-b4x1024"]
ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in
                                 harness.load_cell(workload)["end_to_end"]}


def _alter_logits(monkeypatch):
    from repro_torch.models import resnet

    real = resnet.forward

    def altered(*a, **k):
        logits, state = real(*a, **k)
        logits = logits.clone()
        logits[0, 0] += 10 * logits.abs().max()
        return logits, state

    monkeypatch.setattr(resnet, "forward", altered)


def _alter_tokens(monkeypatch):
    """The prefill's first token of row 0 becomes the one its logits rank
    last."""
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._prefill

    def altered(self, prompts):
        logits = real(self, prompts).clone()
        logits[0] = -logits[0]
        return logits

    monkeypatch.setattr(ServeEngine, "_prefill", altered)


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_produced_is_not_correct(workload,
                                                         monkeypatch):
    if workload.startswith("resnet"):
        _alter_logits(monkeypatch)
    else:
        _alter_tokens(monkeypatch)
    r = run_small(workload)
    assert not r["correct"], r["checks"]


def test_a_macro_call_off_the_kernel_is_not_correct(monkeypatch):
    from repro_torch.kernels import dispatch

    real = dispatch.dispatch

    def to_scan(*a, **k):
        k["backend"] = "scan"
        return real(*a, **k)

    monkeypatch.setattr(dispatch, "dispatch", to_scan)
    r = run_small("qwen2-0.5b.prefill-b4x1024")
    assert r["checks"]["off_kernel"]["value"] > 0
    assert not r["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The reference in the next precision below the configuration's in
    the program's place (TF32 products for the ResNet, float8 e4m3
    activations for Qwen2) fails the cell's limit; the program passes."""
    spec = small_spec(workload)
    limits = spec["limits"]["limits"]
    r = probe.readings(spec, 2**31 + 99, control=True, device="cpu",
                       sync=lambda: None)
    assert harness.check_limits(dict(r["sound"], off_kernel=0), limits)
    assert not harness.check_limits(dict(r["control"], off_kernel=0), limits)


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ gives no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from perfbench import harness; "
            "spec = harness.load_cell(sys.argv[1]); "
            "harness.run_cell(spec, seed=1, seconds=0, trace=False, "
            "device='cpu', t_start=time.perf_counter(), sync=lambda: None)")
    p = subprocess.run([sys.executable, "-c", code, CELLS[0]], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr
    json.loads((tmp_path / "BENCHMARK.json").read_text())
