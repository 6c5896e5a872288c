"""repro_torch.examples against the JAX package's examples/ and the
reference functions they call, on the CPU at smoke size.

  * quickstart: its noiseless sections on the example's own numpy inputs
    equal the reference's ``cim_matmul_int``, ``cim_matmul_exact_int``,
    ``cim_matmul`` (cim-exact and cim) and ``plan_weights``/``execute``
    bit for bit, B1's plain version equals the scan, the macro op's codes
    and outputs are the reference's, and the energy lines equal
    ``repro.core.macro_report``'s.
  * serve_cim: ``demo`` serves examples/serve_cim.py's five requests with
    the reference's parameters carried across (the port's
    ``transformer.init`` monkeypatched); each request's tokens equal those
    the reference example prints, its engine run under
    ``jax.disable_jit`` (its jitted bfloat16 steps round otherwise; see
    tests/test_torch_serve.py). fp on qwen2, cim-exact on rwkv6: under fp
    rwkv6's recurrences (exp/tanh an ulp apart in float32, the state
    stored in bfloat16) move logits by up to ~0.06 and flip a greedy
    token at a near-tie (request 3 at its third token here; see
    tests/test_torch_serve_moe_ssm.py), while under a CIM mode its tokens
    are held equal.
  * train_lm: examples/train_lm.py's fp and QAT runs at 4 steps, batch 2,
    sequence 16, from the reference's parameters (the port's
    ``transformer.init`` monkeypatched), the reference run eagerly: each
    step's batch, learning rate, first loss and gradient norm, fp's
    second loss, and every loss within the reference's own spread (see
    the test). The QAT run is the reference's ``cim`` against the port's
    ``cim-kernel`` (B1's plain version on the CPU, the same transfer bit
    for bit). The port's losses fall, and a rerun resumes from the
    checkpoint and continues the data stream at its step.
  * cim_accuracy_study: the whole study at a tiny profile (4 images a
    batch, one point per sweep, 16 calibration samples a layer); its
    noiseless accuracies (fp, the cutoff sweep, Table I) equal the
    reference's ``benchmarks.common.evaluate`` of the reference's
    baseline under ``cim_policy`` at the same images, the arguments
    examples/cim_accuracy_study.py passes. The noisy ones draw from each
    package's own generator and the calibrations score under noise, so
    they are held to their ranges and structure only.
"""

import functools
import importlib
import io
import pathlib
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs.base import CIMPolicy as JPolicy
from repro.configs.base import get_config as jget
from repro.data import MarkovLM as JMarkovLM
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.examples import (
    cim_accuracy_study,
    quickstart,
    serve_cim,
    train_lm,
)
from repro_torch.models import transformer as tt
from repro_torch.sweep import measures

ROOT = pathlib.Path(__file__).resolve().parent.parent
JOP = jcore.PAPER_OP_16ROWS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _keep_backends(monkeypatch, tmp_path):
    """The study registers calibrated backends; the registry and the
    tuning caches are left as they were."""
    monkeypatch.setattr(tengine, "_BACKENDS", dict(tengine._BACKENDS))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path / "tune"))


def test_quickstart_equals_reference():
    out = quickstart.main(["--device", "cpu"])
    ops = quickstart.operands()
    assert out["scan_equals_kernel"] and out["planned_equals_one_shot"]

    op = jcore.macro_op(jnp.asarray(ops["x16"]), jnp.asarray(ops["w16"]), JOP)
    np.testing.assert_array_equal(out["macro"]["adc_codes"],
                                  np.asarray(op.adc_codes))
    np.testing.assert_array_equal(out["macro"]["outputs"],
                                  np.asarray(op.outputs))

    xm, wm = jnp.asarray(ops["xm"]), jnp.asarray(ops["wm"])
    want = np.asarray(jcore.cim_matmul_int(xm, wm, JOP))
    np.testing.assert_array_equal(out["y_scan"], want)
    np.testing.assert_array_equal(out["y_kernel"], want)
    np.testing.assert_array_equal(
        out["y_exact_int"], np.asarray(jcore.cim_matmul_exact_int(xm, wm)))

    x, w = jnp.asarray(ops["x"]), jnp.asarray(ops["w"])
    for mode, key in (("cim-exact", "y_cim_exact"), ("cim", "y_cim")):
        np.testing.assert_array_equal(out[key], np.asarray(jcore.cim_matmul(
            x, w, JOP, mode=mode, act_symmetric=True)), err_msg=mode)
    policy = JPolicy(mode="cim", cim=JOP, act_symmetric=True)
    plan = jcore.engine.plan_weights(w, JOP, policy)
    np.testing.assert_array_equal(
        out["y_planned"], np.asarray(jcore.engine.execute(x, plan, policy)))
    np.testing.assert_array_equal(out["y_next"], np.asarray(
        jcore.engine.execute(jnp.asarray(ops["x_next"]), plan, policy)))

    for vdd, tops, mhz in out["energy"]:
        rep = jcore.macro_report(JOP.replace(vdd=vdd))
        assert (tops, mhz) == (rep.tops_per_w, rep.freq_mhz), vdd


def _reference_example(name: str):
    """examples/<name>.py of the JAX package, as a module."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT / "examples"))


def _reference_demo(arch, mode) -> dict[int, list[int]]:
    """Tokens examples/serve_cim.py prints for one demo."""
    jexample = _reference_example("serve_cim")
    buf = io.StringIO()
    with jax.disable_jit(), redirect_stdout(buf):
        jexample.demo(arch, mode)
    return {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
            for m in re.finditer(r"req(\d+): prompt\[\d+\] -> \[([^]]*)\]",
                                 buf.getvalue())}


@pytest.mark.parametrize("arch,mode", [("qwen2_0_5b", "fp"),
                                       ("rwkv6_1_6b", "cim-exact")])
def test_serve_cim_tokens_equal_reference(arch, mode, monkeypatch):
    jparams = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(0),
                                               jget(arch, smoke=True)))
    monkeypatch.setattr(tt, "init", lambda seed, cfg, *, device: (
        convert.to_torch(jparams, device=device)))
    got = serve_cim.demo(arch, mode, "cpu")
    want = _reference_demo(arch, mode)
    assert sorted(got) == list(range(5))
    assert [len(got[r]) for r in range(5)] == [g for _, g in
                                               serve_cim.SCHEDULE]
    assert got == want


def _recording(make_train_step, record: list):
    """make_train_step whose steps append (batch, loss, lr, grad_norm)."""
    def make(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            record.append(({k: np.asarray(v) for k, v in batch.items()},
                           *(float(metrics[k]) for k in
                             ("loss", "lr", "grad_norm"))))
            return state, metrics
        return recorded
    return make


LM_SMOKE = ["--steps", "4", "--batch", "2", "--seq", "16"]


def test_train_lm_steps_equal_reference(tmp_path, monkeypatch):
    """After the first update the two runs part: an update moves weights
    by ~lr in directions the float32 roundoff of either package sets, and
    under QAT the moved weights flip ADC codes. The reference run jitted
    against the same run eager already differs by 1.2e-3 (fp, third
    loss) and 1.1e-2 (QAT, second loss) relative (my CPU run), so every
    loss is held within 2e-2 of the reference's, and the tight checks are
    where the runs have not parted yet."""
    jex = _reference_example("train_lm")
    got, want = [], []
    monkeypatch.setattr(train_lm, "make_train_step",
                        _recording(train_lm.make_train_step, got))
    monkeypatch.setattr(jex, "make_train_step",
                        _recording(jex.make_train_step, want))
    monkeypatch.setattr(train_lm, "CIM_MIN_STEPS", 4)
    jparams = {cim: jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(0),
                                                     jex.build_cfg(cim)))
               for cim in (False, True)}
    monkeypatch.setattr(tt, "init", lambda seed, cfg, *, device: (
        convert.to_torch(jparams[cfg.cim.mode != "fp"], device=device)))
    out = train_lm.main(["--device", "cpu", "--cim", "--ckpt-dir",
                         str(tmp_path / "port"), *LM_SMOKE])
    with jax.disable_jit(), redirect_stdout(io.StringIO()):
        for cim, label in ((False, "fp"), (True, "cim-qat")):
            jex.run(jex.build_cfg(cim), 4, 2, 16, str(tmp_path / label),
                    label)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        label, step = ("fp", "cim-qat")[i // 4], i % 4
        where = f"{label} step {step}"
        assert g[0].keys() == w[0].keys(), where
        for k in w[0]:
            np.testing.assert_array_equal(g[0][k], w[0][k], err_msg=where)
        np.testing.assert_allclose(g[2], w[2], rtol=1e-6, err_msg=where)
        np.testing.assert_allclose(g[1], w[1], rtol=2e-2, err_msg=where)
        if step == 0:  # the same weights and batch; the gradients' norm
            # as tests/test_torch_train.py holds the gradients (1e-3)
            np.testing.assert_allclose(g[1], w[1], rtol=1e-6, err_msg=where)
            np.testing.assert_allclose(g[3], w[3], rtol=1e-3, err_msg=where)
        if step == 1 and label == "fp":  # one update apart
            np.testing.assert_allclose(g[1], w[1], rtol=1e-5, err_msg=where)
        assert out[label]["losses"][step] == g[1], where


def test_train_lm_losses_fall_and_rerun_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(train_lm, "CIM_MIN_STEPS", 4)
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "lm")]
    out = train_lm.main(argv + ["--steps", "4", "--cim"])
    for label in ("fp", "cim-qat"):
        run = out[label]
        assert run["resumed"] == 0 and len(run["losses"]) == 4, label
        assert run["losses"][-1] < run["losses"][0], (label, run["losses"])
        assert run["last"] == run["losses"][-1]
    batches = []
    monkeypatch.setattr(train_lm, "make_train_step",
                        _recording(train_lm.make_train_step, batches))
    again = train_lm.main(argv + ["--steps", "6"])["fp"]
    assert again["resumed"] == 4 and len(again["losses"]) == 2
    assert all(np.isfinite(again["losses"]))
    lm = JMarkovLM(64, seed=0, branching=1)
    for step, (batch, *_) in enumerate(batches, start=4):
        want = lm.batch(2, 16, step)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


def test_cim_accuracy_study_runs_at_a_tiny_profile(tmp_path, monkeypatch):
    tiny = dict(
        n_images=4, max_samples=16,
        fig7b={"axes": {"rows_active": [16], "adc_bits": [4]},
               "params": {"n_images": 4}},
        study={"axes": {"variant": ["p8t", "adder-tree"], "vdd": [0.6]},
               "params": {"budget": 1, "n_cal": 4, "n_held": 4,
                          "max_samples": 16, "adc_bits": [4]}},
    )
    monkeypatch.setitem(cim_accuracy_study.PROFILES, "fast", tiny)
    monkeypatch.setattr(cim_accuracy_study, "SWEEP_DIR", tmp_path)
    small = functools.partial(measures.evaluate, batch=4)
    monkeypatch.setattr(measures, "evaluate", small)
    monkeypatch.setattr(cim_accuracy_study, "evaluate", small)
    out = cim_accuracy_study.main(["--fast", "--device", "cpu"])
    accs = [out["fp"], *out["cutoff"].values(), *out["fig7b"].values(),
            *out["table1"].values()]
    accs += [out[b][k] for b in ("analog", "analog-variants")
             for k in ("noisy", "ideal")]
    assert len(out["cutoff"]) == 6 and list(out["fig7b"]) == [(16, 4)]
    assert len(out["table1"]) == 4
    assert all(0.0 <= a <= 1.0 for a in accs)
    monkeypatch.syspath_prepend(str(ROOT))
    jcommon = importlib.import_module("benchmarks.common")
    jp, jbn, ds = jcommon.train_resnet_baseline()

    def reference(policy):
        return jcommon.evaluate(jp, jbn, ds, policy, n_images=4, batch=4)

    assert out["fp"] == reference(JPolicy(mode="fp"))
    for cutoff in (0.25, 0.5, 0.75):
        assert out["cutoff"][cutoff, False] == reference(
            jcommon.cim_policy(cutoff=cutoff)), cutoff
    for rows in (8, 16):
        assert out["table1"][rows, False] == reference(
            jcommon.cim_policy(rows=rows)), rows
    assert out["analog"]["variants"] == ["p8t"]
    assert out["pareto"].exists() and out["pareto"].parent.parent == tmp_path
    assert sorted(p.name.rsplit("_", 1)[0] for p in tmp_path.iterdir()) == [
        "accuracy_study", "resnet_study"]
