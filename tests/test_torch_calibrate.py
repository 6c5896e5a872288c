"""repro_torch.core.calibrate (the execution half) against the JAX
reference, on the CPU.

The saved calibration results in results/calibration/ (one per macro
variant, written by the reference's ``save_result``) load to equal fields
in both packages and are written back byte for byte by the port. Each is
registered as an engine backend in both packages and drives the committed
ResNet checkpoint on the same 8 synthetic eval images.

Tolerances and why: every macro conv output for identical activations
and an identical plan is held bit for bit (exact integer macro
arithmetic, same float32 epilogue). Logits are held to 2e-2 absolute
(they are O(10)) with equal top-1, as in tests/test_torch_resnet.py: the
digital layers sum in another order than XLA, which can move a 4-bit
activation code that sits on a rounding boundary.
"""

import dataclasses
import json
import pathlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs.base import CIMPolicy as JPolicy
from repro.core import calibrate as jcal
from repro.core import dac as jdac
from repro.core import engine as jengine
from repro.core.params import PAPER_OP_16ROWS as J_PAPER
from repro.core.pipeline import MacroSpec as JSpec
from repro.core.pipeline import default_pipeline as j_default_pipeline
from repro.models import resnet as jresnet
from repro_torch import convert
from repro_torch.configs import resnet as tcfg
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import calibrate as tcal
from repro_torch.core import dac as tdac
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as T_PAPER
from repro_torch.core.pipeline import MacroSpec as TSpec
from repro_torch.core.pipeline import default_pipeline as t_default_pipeline
from repro_torch.kernels import dispatch
from repro_torch.models import resnet as tresnet

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = {v: ROOT / "results" / "calibration" / f"resnet_paper_{v}.json"
            for v in ("p8t", "adder-tree", "cell-adc")}
BACKEND = "analog-parity-test"
N_IMAGES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def backend_name():
    """A backend name registered in both packages for one test only."""
    yield BACKEND
    jengine._BACKENDS.pop(BACKEND, None)
    tengine._BACKENDS.pop(BACKEND, None)


def _spec_fields(spec) -> dict:
    return dataclasses.asdict(spec.to_config())


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(FIXTURES))
def test_fixture_loads_equal_and_saves_byte_for_byte(variant, tmp_path):
    path = FIXTURES[variant]
    jres, tres = jcal.load_result(path), tcal.load_result(path)
    assert tcal.result_to_dict(tres) == jcal.result_to_dict(jres)
    assert _spec_fields(tres.base) == _spec_fields(jres.base)
    assert dataclasses.asdict(tres.grid) == dataclasses.asdict(jres.grid)
    assert (tres.slack, tres.cost_unit, tres.refinement) == \
        (jres.slack, jres.cost_unit, None)
    assert list(tres.layers) == list(jres.layers)
    assert len(tres.layers) == 14
    for name, tl in tres.layers.items():
        jl = jres.layers[name]
        assert (tl.k, tl.n, tl.variant, tl.score, tl.cost, tl.skipped,
                tl.table) == (jl.k, jl.n, jl.variant, jl.score, jl.cost,
                              jl.skipped, ())
        assert tl.variant == variant
        assert _spec_fields(tl.spec) == _spec_fields(jl.spec)
    assert tres.operating_point() == jres.operating_point() == (4, 16)
    out = tcal.save_result(tres, tmp_path / "again.json")
    assert out.read_bytes() == path.read_bytes()


def test_refined_payload_round_trips_like_reference():
    payload = json.loads(FIXTURES["p8t"].read_text())
    payload["refinement"] = {
        "seed_accuracy": 0.75, "final_accuracy": 0.6875, "tol": 0.1,
        "budget": 3, "evals_used": 2,
        "moves": [{"layer": "s0b0/conv1", "variant": "p8t", "adc_bits": 3,
                   "rows_active": 16, "cutoff": 0.5, "vdd": 0.6,
                   "cost_before": 0.5, "cost_after": 0.375,
                   "accuracy": 0.6875, "accepted": True}],
    }
    tres = tcal.result_from_dict(payload)
    assert tres.refinement.moves[0].accepted is True
    assert tcal.result_to_dict(tres) == \
        jcal.result_to_dict(jcal.result_from_dict(payload))
    with pytest.raises(ValueError, match="version"):
        tcal.result_from_dict({**payload, "version": 2})


def test_layer_lookup_warns_once_and_is_strict_on_request():
    res = tcal.load_result(FIXTURES["adder-tree"])
    assert res.variant_for(144, 16) == "adder-tree"
    assert res.spec_for(576, 64).rows_active == 16
    with pytest.warns(UserWarning, match="falling back"):
        assert res.layer_for(7, 7) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert res.spec_for(7, 7) == res.base  # warned once already
        assert res.variant_for(7, 7) == "p8t"
    with pytest.raises(KeyError, match="no calibrated layer"):
        res.layer_for(7, 7, strict=True)
    layers = dict(res.layers)
    lc = layers["s0b0/conv2"]
    layers["s0b0/conv2"] = dataclasses.replace(
        lc, spec=lc.spec.replace(adc_bits=5), cost=lc.cost + 1.0)
    mixed = dataclasses.replace(res, layers=layers)
    with pytest.warns(UserWarning, match="share shape"):
        assert mixed.layer_for(144, 16).name == "s0b0/conv2"


# ---------------------------------------------------------------------------
# The table (LUT) path: a calibrated pipeline whose ADC is not the floor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TorchNearestADCStage:
    """A swapped ADC stage: snap the voltage to the pMAC grid, then
    round half up (the behavioral 'nearest' transfer)."""

    name: str = "adc"

    def __call__(self, state, spec):
        pmac = torch.round(tdac.pmac_from_abl_voltage(state.v_abl, spec))
        code = torch.clamp(torch.floor(pmac / spec.adc_step + 0.5), 0,
                           spec.adc_codes - 1)
        return state.evolve(adc_codes=code.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class JaxNearestADCStage:
    name: str = "adc"

    def __call__(self, state, spec):
        pmac = jnp.round(jdac.pmac_from_abl_voltage(state.v_abl, spec))
        code = jnp.clip(jnp.floor(pmac / spec.adc_step + 0.5), 0,
                        spec.adc_codes - 1)
        return state.evolve(adc_codes=code.astype(jnp.int32))


def _one_layer_result(cal, spec_cls, paper, pipeline, k, n):
    spec = spec_cls.from_config(paper).replace(adc_coarse_bits=0)
    layer = cal.LayerCalibration(name="l", k=k, n=n, spec=spec, score=0.1,
                                 cost=0.25, table=())
    return cal.CalibrationResult(
        layers={"l": layer}, base=spec_cls.from_config(paper),
        grid=cal.CalibrationGrid(), slack=2.0, pipeline=pipeline)


def test_lut_path_replays_a_swapped_adc_stage_like_reference(backend_name):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((23, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 9)) / 8).astype(np.float32)
    tpipe = t_default_pipeline().replace_stage("adc", TorchNearestADCStage())
    jpipe = j_default_pipeline().replace_stage("adc", JaxNearestADCStage())
    tres = _one_layer_result(tcal, TSpec, T_PAPER, tpipe, 70, 9)
    jres = _one_layer_result(jcal, JSpec, J_PAPER, jpipe, 70, 9)
    table = tcal.adc_code_table(tpipe, tres.layers["l"].spec)
    np.testing.assert_array_equal(
        table.numpy(),
        np.asarray(jcal.adc_code_table(jpipe, jres.layers["l"].spec)))
    tres.register(backend_name)
    jres.register(backend_name)
    tpol = TPolicy(mode="cim", backend=backend_name, cim=T_PAPER)
    jpol = JPolicy(mode="cim", backend=backend_name, cim=J_PAPER)
    jplan = jengine.plan_weights(jnp.asarray(w), jpol.cim, jpol)
    tplan = tengine.plan_weights(torch.from_numpy(w), tpol.cim, tpol)
    np.testing.assert_array_equal(tplan.codes.numpy(),
                                  np.asarray(jplan.codes))
    # The macro output for identical codes, bit for bit.
    codes = rng.integers(0, 16, (23, 70)).astype(np.int32)
    spec = tres.layers["l"].spec
    got_int = tcal._lut_matmul_int(torch.from_numpy(codes), tplan.codes_i32,
                                   spec, table, None, planes=tplan.planes)
    want_int = jcal._lut_matmul_int(jnp.asarray(codes), jplan.codes_i32,
                                    jres.layers["l"].spec,
                                    jnp.asarray(table.numpy()), None,
                                    planes=jplan.planes)
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(want_int))
    # Through the registered backends, with the shared float epilogue.
    with dispatch.record_resolutions() as log:
        got = tengine.execute(torch.from_numpy(x), tplan, tpol)
    assert log == []  # the table path, not a dispatched kernel
    want = jengine.execute(jnp.asarray(x), jplan, jpol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    nearest = tengine.execute(torch.from_numpy(x), tplan, TPolicy(
        mode="cim", cim=T_PAPER.replace(adc_mode="nearest")))
    floor = tengine.execute(torch.from_numpy(x), tplan,
                            TPolicy(mode="cim", cim=T_PAPER))
    np.testing.assert_array_equal(got.numpy(), nearest.numpy())
    assert not np.array_equal(got.numpy(), floor.numpy())


def test_register_overwrite_contract(backend_name):
    res = tcal.load_result(FIXTURES["p8t"])
    assert res.register(backend_name) == backend_name
    res.register(backend_name)  # the default overwrites
    with pytest.raises(ValueError, match="already registered"):
        res.register(backend_name, overwrite=False)
    with pytest.raises(ValueError, match="already registered"):
        tengine.register_backend(backend_name, lambda *a: None)
    tengine.register_backend(backend_name, lambda *a: None, overwrite=True)
    bad = TPolicy(mode="cim", backend=backend_name,
                  cim=T_PAPER.replace(act_bits=2))
    res.register(backend_name)
    plan = tengine.plan_weights(torch.randn(144, 16), bad.cim, bad)
    with pytest.raises(ValueError, match="act_bits"):
        tengine.execute(torch.randn(4, 144), plan, bad)


# ---------------------------------------------------------------------------
# The committed checkpoint under each saved result
# ---------------------------------------------------------------------------


def _jcfg(policy):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import common
    finally:
        sys.path.remove(str(ROOT))
    return dataclasses.replace(common.RESNET_CFG, cim=policy)


@pytest.fixture(scope="module")
def checkpoint():
    jcfg = _jcfg(JPolicy(mode="fp", act_symmetric=True))
    target = jax.eval_shape(
        lambda: jresnet.init(jax.random.PRNGKey(0), jcfg))
    jtree = jstore.restore(ROOT / "results" / "resnet_baseline",
                           {"params": target[0], "bn": target[1]})
    tparams, tbn = tcfg.load_baseline(device="cpu")
    batch = tcfg.dataset().batch(N_IMAGES, step=0, train=False)
    return dict(jparams=jtree["params"], jbn=jtree["bn"], tparams=tparams,
                tbn=tbn, batch=batch)


def _torch_plan(jplan):
    """A reference PlannedWeights carried across field for field."""
    fields = ("codes", "scale", "colsum", "w", "planes", "slots")
    return tengine.PlannedWeights(
        **{f: None if getattr(jplan, f) is None
           else convert.to_torch(getattr(jplan, f), device="cpu")
           for f in fields},
        weight_bits=jplan.weight_bits)


@pytest.mark.parametrize("variant", list(FIXTURES))
def test_checkpoint_under_saved_result_matches_reference(
        variant, checkpoint, backend_name, monkeypatch):
    """Both packages register the saved result and run the checkpoint
    under cim-kernel + that backend. The reference's forward taps every
    macro conv's activations and records its output; the port executes
    the same activations against the same plan (carried across) and must
    give it bit for bit. Then the port's own forward: logits and top-1."""
    ck = checkpoint
    jcal.load_result(FIXTURES[variant]).register(backend_name)
    tcal.load_result(FIXTURES[variant]).register(backend_name)
    jpol = dataclasses.replace(
        JPolicy(mode="cim-kernel", cim=J_PAPER.replace(vdd=0.6),
                act_symmetric=True, act_clip_pct=0.995),
        backend=backend_name)
    jcfg = _jcfg(jpol)
    tpol = dataclasses.replace(tcfg.cim_policy(mode="cim-kernel"),
                               backend=backend_name)
    assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)
    taps, outs = [], []
    real_execute = jengine.execute

    def recording_execute(x, plan, policy, **kw):
        y = real_execute(x, plan, policy, **kw)
        outs.append(np.asarray(y))
        return y

    monkeypatch.setattr(jengine, "execute", recording_execute)
    jplanned = jax.jit(lambda p: jresnet.plan_params(p, jpol))(ck["jparams"])
    jl, _ = jresnet.forward(jplanned, ck["jbn"],
                            jnp.asarray(ck["batch"]["image"]), jcfg,
                            tap=lambda name, x2, plan: taps.append(
                                (name, np.array(x2), plan)))
    assert len(taps) == len(outs) == 14
    with dispatch.record_resolutions() as log:
        for (name, x2, jplan), want in zip(taps, outs, strict=True):
            got = tengine.execute(torch.from_numpy(x2), _torch_plan(jplan),
                                  tpol)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # On the CPU the heuristic takes the variant's scan twin; on a CUDA
    # device it takes the variant's kernel (chip_smoke.py).
    assert {(r.key.variant, r.key.backend, r.source) for r in log} == {
        (variant, "scan", "heuristic")}
    tc = dataclasses.replace(tcfg.RESNET_CFG, cim=tpol)
    with torch.no_grad():
        tl, _ = tresnet.forward(tresnet.plan_params(ck["tparams"], tpol),
                                ck["tbn"],
                                torch.from_numpy(ck["batch"]["image"]), tc)
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    np.testing.assert_allclose(tl, jl, atol=2e-2)
