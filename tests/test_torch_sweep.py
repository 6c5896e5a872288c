"""The calibration sweep of repro_torch (slice 4: ``calibrate``,
``refine``, ``pareto``/``project``, ``calibrate_resnet``,
``resnet_eval_fn``, ``save_result`` with a refinement) against the JAX
reference, on the CPU, at small sizes: the ``variants_bench.py --smoke``
layer (K 64, N 8, M 32), test_refine.py's two layers, and the ResNet of
tests/test_calibrate.py (widths (8, 16), one block, 8 images).

Tolerances: a noiseless sweep selects the same spec and variant with the
same cost and skipped points per layer, and every table entry's spec,
variant, cost and order equal; scores are float32 relative L2 errors of
exact integer outputs whose norms sum in another order than XLA's, held
at rtol 1e-6. Refinement and pareto reports equal the reference's
(moves, evals used, points; scores at rtol 1e-6). Noisy sweeps draw from
torch generators: their scores are held per grid point to the
reference's within 5 standard errors of the difference of two means over
``n_noise_keys`` draws, and the paper grid selects the reference's
(4, 16).
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CIMPolicy as JPolicy
from repro.core import calibrate as jcal
from repro.core import engine as jengine
from repro.core.params import CIMConfig as JConfig
from repro.core.pipeline import MacroSpec as JSpec
from repro.core.pipeline import default_pipeline as j_default_pipeline
from repro.models import resnet as jresnet
from repro.sweep.measures import stub_eval_fn
from repro_torch import convert
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import calibrate as tcal
from repro_torch.core import engine as tengine
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.core.pipeline import MacroSpec as TSpec
from repro_torch.core.pipeline import default_pipeline as t_default_pipeline
from repro_torch.kernels import dispatch
from repro_torch.models import resnet as tresnet

VARIANTS = ("p8t", "adder-tree", "cell-adc")
VDD_GRID = dict(adc_bits=(3, 4), rows_active=(16,), coarse_bits=(1,),
                variants=("p8t", "cell-adc"), vdd=(0.6, 0.9))
RESNET_GRID = dict(adc_bits=(3, 4), rows_active=(16,), coarse_bits=(1,))
# The small layer's grid: the default one without rows 4 (which never
# wins the cost race), all three variants.
SMALL_GRID = dict(rows_active=(8, 16), variants=VARIANTS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_layer():
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(64, 8)) * 0.1).astype(np.float32)
    x = np.maximum(rng.normal(size=(32, 64)), 0).astype(np.float32)
    return w, x


def _two_layer(seed=3):
    rng = np.random.default_rng(seed)
    weights = {"a": (rng.normal(size=(64, 8)) * 0.1).astype(np.float32),
               "b": (rng.normal(size=(32, 8)) * 0.1).astype(np.float32)}
    acts = {k: np.maximum(rng.normal(size=(32, w.shape[0])), 0).astype(
        np.float32) for k, w in weights.items()}
    return weights, acts


def _both(weights, acts, grid, **kw):
    """The same sweep in both packages: (reference, port)."""
    jr = jcal.calibrate(j_default_pipeline(),
                        {k: jnp.asarray(v) for k, v in weights.items()},
                        {k: jnp.asarray(v) for k, v in acts.items()},
                        jcal.CalibrationGrid(**grid), **kw)
    tr = tcal.calibrate(t_default_pipeline(),
                        {k: torch.from_numpy(v) for k, v in weights.items()},
                        {k: torch.from_numpy(v) for k, v in acts.items()},
                        tcal.CalibrationGrid(**grid), **kw)
    return jr, tr


_SHARED: dict = {}


def _shared(name, make):
    if name not in _SHARED:
        _SHARED[name] = make()
    return _SHARED[name]


def small_results():
    w, x = _small_layer()
    return _shared("small", lambda: _both({"l": w}, {"l": x}, SMALL_GRID,
                                          noisy=False, seed=0))


def vdd_results():
    return _shared("vdd", lambda: _both(*_two_layer(), VDD_GRID,
                                        noisy=False))


def _fields(spec) -> dict:
    return dataclasses.asdict(spec.to_config())


def assert_layers_match(jr, tr, rtol=1e-6):
    assert list(tr.layers) == list(jr.layers)
    assert (tr.slack, tr.cost_unit) == (jr.slack, jr.cost_unit)
    assert _fields(tr.base) == _fields(jr.base)
    for name, jl in jr.layers.items():
        tl = tr.layers[name]
        assert (tl.k, tl.n, tl.variant, tl.cost, tl.skipped) == \
            (jl.k, jl.n, jl.variant, jl.cost, jl.skipped), name
        assert _fields(tl.spec) == _fields(jl.spec), name
        np.testing.assert_allclose(tl.score, jl.score, rtol=rtol)
        assert len(tl.table) == len(jl.table)
        for tp, jp in zip(tl.table, jl.table):
            assert (tp.variant, tp.cost, tp.order, tp.point) == \
                (jp.variant, jp.cost, jp.order, jp.point)
            assert _fields(tp.spec) == _fields(jp.spec)
            np.testing.assert_allclose(tp.score, jp.score, rtol=rtol,
                                       atol=1e-12)


def assert_reports_match(tr, jr):
    a, b = tr.refinement, jr.refinement
    assert (a.budget, a.evals_used, a.tol) == (b.budget, b.evals_used, b.tol)
    assert (a.seed_accuracy, a.final_accuracy) == \
        (b.seed_accuracy, b.final_accuracy)
    assert [dataclasses.astuple(m) for m in a.moves] == \
        [dataclasses.astuple(m) for m in b.moves]


# ---------------------------------------------------------------------------
# calibrate: noiseless, bit for bit up to the float32 norm
# ---------------------------------------------------------------------------


def test_noiseless_sweep_matches_reference():
    jr, tr = small_results()
    assert_layers_match(jr, tr)
    assert tr.operating_point() == jr.operating_point()
    assert tr.effective_tops_per_w() == jr.effective_tops_per_w()
    assert tr.summary() == jr.summary()
    assert tr.layers["l"].adc_spec == tr.layers["l"].spec.adc
    for spec in (TSpec(), TSpec().replace(rows_active=8, adc_bits=3)):
        assert tcal.hw_cost(spec) == jcal.hw_cost(
            JSpec().replace(rows_active=spec.rows_active,
                            adc_bits=spec.adc_bits))


@pytest.mark.parametrize("variant", VARIANTS)
def test_projection_matches_reference(variant):
    jr, tr = small_results()
    for vdd in (None, 0.9):
        assert_layers_match(jr.project(variant, vdd=vdd),
                            tr.project(variant, vdd=vdd))


def test_skipped_points_and_axis_validation_match_reference():
    """A swept cutoff makes points infeasible (a reference level beyond
    the arrays' charge, no integer spacing): skipped with the
    reference's reasons. Bad vdd/cutoff axes raise up front with the
    reference's messages; an all-infeasible grid raises."""
    w, x = _small_layer()
    grid = dict(adc_bits=(4, 8), rows_active=(16,), coarse_bits=(1,),
                cutoff=(0.0, 0.5))
    jr, tr = _both({"l": w}, {"l": x}, grid, noisy=False)
    assert_layers_match(jr, tr)
    assert any("not representable" in s for s in tr.layers["l"].skipped)
    assert any("reference spacing" in s for s in tr.layers["l"].skipped)
    for bad in (dict(vdd=(0.3,)), dict(cutoff=(1.0,))):
        with pytest.raises(ValueError) as te:
            tcal.calibrate(t_default_pipeline(), {"l": torch.from_numpy(w)},
                           {"l": torch.from_numpy(x)},
                           tcal.CalibrationGrid(**bad))
        with pytest.raises(ValueError) as je:
            jcal.calibrate(j_default_pipeline(), {"l": jnp.asarray(w)},
                           {"l": jnp.asarray(x)},
                           jcal.CalibrationGrid(**bad))
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="empty feasible grid"):
        tcal.calibrate(t_default_pipeline(), {"l": torch.from_numpy(w)},
                       {"l": torch.from_numpy(x)},
                       tcal.CalibrationGrid(adc_bits=(8,), rows_active=(16,)),
                       noisy=False)


def test_planned_weights_and_tie_break_match_reference():
    """A PlannedWeights layer is calibrated from its codes; slack < 1
    forces the fallback rule, whose exact score ties break by cost and
    grid order as in the reference."""
    jres_, tres_ = small_results()
    w, x = _small_layer()
    plan = tengine.plan_weights(torch.from_numpy(w), TConfig())
    r = tcal.calibrate(t_default_pipeline(), {"l": plan},
                       {"l": torch.from_numpy(x)},
                       tcal.CalibrationGrid(**SMALL_GRID), noisy=False)
    assert _fields(r.layers["l"].spec) == _fields(tres_.layers["l"].spec)
    grid = dict(adc_bits=(4, 5), rows_active=(8, 16), coarse_bits=(1, 2))
    jr, tr = _both({"l": w}, {"l": x}, grid, noisy=False, slack=0.5)
    assert_layers_match(jr, tr)
    lc = tr.layers["l"]
    assert lc.score == min(p.score for p in lc.table)


# ---------------------------------------------------------------------------
# refine, pareto and persistence on the two-layer vdd grid
# ---------------------------------------------------------------------------


def test_vdd_sweep_refine_and_pareto_match_reference(tmp_path):
    jr, tr = vdd_results()
    assert_layers_match(jr, tr)
    assert tr.cost_unit == "fJ/MAC"
    jref = jcal.refine(jr, stub_eval_fn(), budget=6, tol=0.02)
    tref = tcal.refine(tr, stub_eval_fn(), budget=6, tol=0.02)
    assert_reports_match(tref, jref)
    assert_layers_match(jref, tref)
    for ev in (None, stub_eval_fn()):
        jp = jr.pareto(eval_fn=ev)
        tp = tr.pareto(eval_fn=ev)
        assert [(p.variant, p.vdd, p.tops_per_w, p.accuracy, p.frontier)
                for p in tp] == \
            [(p.variant, p.vdd, p.tops_per_w, p.accuracy, p.frontier)
             for p in jp]
        np.testing.assert_allclose([p.score for p in tp],
                                   [p.score for p in jp], rtol=1e-6)
    # save_result with the refinement: the reference's JSON, every byte
    # but the digits of the float32 scores (held at rtol 1e-6).
    tpath = tcal.save_result(tref, tmp_path / "port.json")
    jpath = jcal.save_result(jref, tmp_path / "ref.json")
    tj, jj = json.loads(tpath.read_text()), json.loads(jpath.read_text())
    for name in jj["layers"]:
        np.testing.assert_allclose(tj["layers"][name].pop("score"),
                                   jj["layers"][name].pop("score"),
                                   rtol=1e-6)
    assert tj == jj
    assert "refinement" in tj
    back = tcal.load_result(tpath)
    assert back.refinement == tref.refinement
    with pytest.raises(ValueError, match="sweep tables"):
        tcal.refine(back, stub_eval_fn(), budget=2)
    with pytest.raises(ValueError, match="sweep tables"):
        back.pareto()
    with pytest.raises(ValueError, match="budget"):
        tcal.refine(tr, stub_eval_fn(), budget=0)


@pytest.mark.parametrize("case", ["reject-all", "accept-all", "floor"])
def test_refine_stub_decisions_match_reference(case):
    """The greedy loop's decisions with stub evals that reject every move,
    accept every move, or sit below the tolerance."""
    jr, tr = vdd_results()

    def make(seed_result):
        if case == "reject-all":
            return lambda r: 1.0 if r is seed_result else 0.0
        if case == "accept-all":
            return lambda r: 1.0
        return lambda r: 0.9 if r is seed_result else 0.8

    budget = {"reject-all": 16, "accept-all": 3, "floor": 6}[case]
    jref = jcal.refine(jr, make(jr), budget=budget, tol=0.05)
    tref = tcal.refine(tr, make(tr), budget=budget, tol=0.05)
    assert_reports_match(tref, jref)
    if case != "accept-all":
        assert tref.layers is tr.layers


# ---------------------------------------------------------------------------
# The ResNet: calibrate_resnet, resnet_eval_fn, refine on real forwards
# ---------------------------------------------------------------------------


def _tiny_resnet():
    def cfg(Policy, Config, mod, noisy=False):
        return mod.ResNetConfig(
            widths=(8, 16), blocks_per_stage=1,
            cim=Policy(mode="cim", cim=Config(rows_active=16, cutoff=0.5,
                                              adc_bits=4, noisy=noisy),
                       act_symmetric=True, act_clip_pct=0.995))

    def make():
        jcfg = cfg(JPolicy, JConfig, jresnet)
        params, bn = jresnet.init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(0)
        images = np.maximum(rng.normal(size=(8, 32, 32, 3)), 0).astype(
            np.float32)
        held = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 10, 8)
        return dict(
            jcfg=jcfg, tcfg=cfg(TPolicy, TConfig, tresnet),
            tcfg_noisy=cfg(TPolicy, TConfig, tresnet, noisy=True),
            jparams=params, jbn=bn,
            tparams=convert.to_torch(jax.tree.map(np.asarray, params),
                                     device="cpu"),
            tbn=convert.to_torch(jax.tree.map(np.asarray, bn),
                                 device="cpu"),
            images=images, held=held, labels=labels)

    return _shared("resnet", make)


def test_calibrate_resnet_and_refine_on_real_evals_match_reference():
    r = _tiny_resnet()
    jres_ = jcal.calibrate_resnet(
        r["jparams"], r["jbn"], jnp.asarray(r["images"]), r["jcfg"],
        grid=jcal.CalibrationGrid(**RESNET_GRID), max_samples=64,
        noisy=False)
    tres_ = tcal.calibrate_resnet(
        r["tparams"], r["tbn"], torch.from_numpy(r["images"]), r["tcfg"],
        grid=tcal.CalibrationGrid(**RESNET_GRID), max_samples=64,
        noisy=False)
    # The conv layers' errors are norms over 64 x 8-16 outputs: the
    # reference's float32 reduction sits up to 1.5e-6 off the exact sum
    # there (the port's sum equals the float64 one), hence 4e-6.
    assert_layers_match(jres_, tres_, rtol=4e-6)
    jev = jcal.resnet_eval_fn(r["jparams"], r["jbn"], jnp.asarray(r["held"]),
                              r["labels"], r["jcfg"])
    tev = tcal.resnet_eval_fn(r["tparams"], r["tbn"],
                              torch.from_numpy(r["held"]),
                              torch.from_numpy(r["labels"]), r["tcfg"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # layers sharing a shape
        jref = jcal.refine(jres_, jev, budget=3, tol=0.01)
        tref = tcal.refine(tres_, tev, budget=3, tol=0.01)
    assert_reports_match(tref, jref)
    assert "__calibrate_eval__" not in tengine.backend_names()


def test_calibrate_resnet_noisy_selects_the_paper_point():
    """The reference's acceptance test on the port: the noisy sweep of
    the ResNet over rows (8, 16) selects 4-bit @ 16 rows, every conv at
    16 rows, the full 3x3 convs at 4 bits, the exempt stem uncalibrated
    -- the reference's (4, 16) and layer set."""
    r = _tiny_resnet()
    res = tcal.calibrate_resnet(
        r["tparams"], r["tbn"], torch.from_numpy(r["images"]), r["tcfg"],
        max_samples=64, n_noise_keys=2,
        grid=tcal.CalibrationGrid(rows_active=(8, 16)))
    assert res.operating_point() == (4, 16)
    assert set(res.layers) == {"s0b0/conv1", "s0b0/conv2", "s1b0/conv1",
                               "s1b0/conv2", "s1b0/proj"}
    for lc in res.layers.values():
        assert lc.spec.rows_active == 16 and lc.spec.adc_bits in (4, 5)
        if lc.k >= 16:
            assert lc.spec.adc_bits == 4
    again = tcal.calibrate_resnet(
        r["tparams"], r["tbn"], torch.from_numpy(r["images"]), r["tcfg"],
        max_samples=64, n_noise_keys=2,
        grid=tcal.CalibrationGrid(rows_active=(8, 16)))
    assert [p.score for lc in again.layers.values() for p in lc.table] == \
        [p.score for lc in res.layers.values() for p in lc.table]


def test_noisy_sweep_scores_match_reference_in_distribution():
    """Noisy scores per grid point (8 noise draws each side) against the
    reference's: within 5 standard errors of the difference, the
    per-draw spread taken from the port's draws."""
    w, x = _small_layer()
    grid = dict(adc_bits=(3, 4, 5), rows_active=(16,), coarse_bits=(1,),
                variants=VARIANTS)
    n = 8
    jr, tr = _both({"l": w}, {"l": x}, grid, noisy=True, n_noise_keys=n,
                   seed=1)
    spread = []
    for seed in range(8):  # the per-draw spread, from independent sweeps
        r = tcal.calibrate(t_default_pipeline(), {"l": torch.from_numpy(w)},
                           {"l": torch.from_numpy(x)},
                           tcal.CalibrationGrid(**grid), noisy=True,
                           n_noise_keys=1, seed=10 + seed)
        spread.append([p.score for p in r.layers["l"].table])
    sd = np.std(np.asarray(spread), axis=0, ddof=1)
    for tp, jp, s in zip(tr.layers["l"].table, jr.layers["l"].table, sd):
        assert (tp.variant, tp.point) == (jp.variant, jp.point)
        tol = 5 * np.sqrt(2 / n) * max(s, 0.02 * jp.score) + 1e-6
        assert abs(tp.score - jp.score) <= tol, (tp, jp, tol)


def test_eval_fn_is_deterministic_noisy_and_cleans_up(monkeypatch):
    """A noisy evaluation under one generator seed gives the same top-1
    twice and routes every macro conv to the scan with source "noise";
    the throwaway backend is removed even when the forward raises."""
    r = _tiny_resnet()
    tr = tcal.calibrate_resnet(
        r["tparams"], r["tbn"], torch.from_numpy(r["images"]), r["tcfg"],
        grid=tcal.CalibrationGrid(**RESNET_GRID), max_samples=64,
        noisy=False)
    held = torch.from_numpy(r["held"])
    labels = torch.from_numpy(r["labels"])
    gen = torch.Generator().manual_seed(7)
    ev = tcal.resnet_eval_fn(r["tparams"], r["tbn"], held, labels,
                             r["tcfg_noisy"], generator=gen)
    with dispatch.record_resolutions() as log, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # layers sharing a shape
        a = ev(tr)
    assert {(x.key.backend, x.source) for x in log} == {("scan", "noise")}
    assert len(log) == 5
    assert ev(tr) == a
    assert isinstance(tresnet.top1_accuracy(
        tresnet.plan_params(r["tparams"], r["tcfg"].cim), r["tbn"], held,
        labels, r["tcfg"]), float)

    def boom(*a, **k):
        raise RuntimeError("forward failed")

    monkeypatch.setattr(tresnet, "top1_accuracy", boom)
    with pytest.raises(RuntimeError, match="forward failed"):
        ev(tr)
    assert "__calibrate_eval__" not in tengine.backend_names()
    assert "__calibrate_eval__" not in jengine.backend_names()
