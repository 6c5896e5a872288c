"""repro_torch.core.engine and kernels.dispatch against the JAX reference.

Plans are bit-exact field for field. ``execute`` is bit-exact for every
quantized backend on identical float inputs (the activation quantizer,
the integer macro transfer and the dequant epilogue all reproduce the
reference's float32 values); the ``fp`` backend is one float32 matmul,
held to 1e-6 relative since the two libraries sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CIMPolicy as JPolicy
from repro.core import engine as jengine
from repro.core.params import CIMConfig as JConfig
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import engine as tengine
from repro_torch.core import matmul as tmatmul
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.kernels import cim_mac, dispatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policies(mode, **cim_kw):
    common = dict(act_symmetric=False, act_clip_pct=0.995)
    return (JPolicy(mode=mode, cim=JConfig(**cim_kw), **common),
            TPolicy(mode=mode, cim=TConfig(**cim_kw), **common))


def _weights(seed, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)


@pytest.mark.parametrize("mode", ["cim-exact", "cim", "cim-kernel"])
@pytest.mark.parametrize("k", [100, 4100])
def test_plan_weights_fields_bit_exact(mode, k):
    jp, tp = _policies(mode)
    w = _weights(k, k, 6)
    jplan = jengine.plan_weights(jnp.asarray(w), jp.cim, jp)
    tplan = tengine.plan_weights(torch.from_numpy(w), tp.cim, tp)
    for f in ("codes", "scale", "colsum", "w", "planes", "slots"):
        jv, tv = getattr(jplan, f), getattr(tplan, f)
        assert (jv is None) == (tv is None), f
        if jv is None:
            continue
        assert tuple(tv.shape) == tuple(jv.shape), f
        assert str(tv.dtype).removeprefix("torch.") == jv.dtype.name, f
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    assert tplan.weight_bits == jplan.weight_bits
    assert (tplan.k, tplan.n) == (jplan.k, jplan.n)


@pytest.mark.parametrize("to_rows", [4, 8, 16])
@pytest.mark.parametrize("packed", [False, True])
def test_regroup_planes_bit_exact(to_rows, packed):
    w = np.random.default_rng(0).integers(-128, 128, (70, 5)).astype(np.int32)
    jp = jengine._grouped_planes(jnp.asarray(w), JConfig(), packed=packed)
    tp = tengine._grouped_planes(torch.from_numpy(w), TConfig(),
                                 packed=packed)
    np.testing.assert_array_equal(
        tengine.regroup_planes(tp, 70, to_rows).numpy(),
        np.asarray(jengine.regroup_planes(jp, 70, to_rows)))


@pytest.mark.parametrize("mode", ["cim-exact", "cim", "cim-kernel"])
@pytest.mark.parametrize("cim_kw", [
    dict(), dict(rows_active=8, adc_bits=3, adc_mode="nearest"),
    dict(rows_active=16, cutoff=0.25),
], ids=["paper", "r8-adc3-nearest", "step12"])
def test_execute_quantized_backends_bit_exact(mode, cim_kw):
    jp, tp = _policies(mode, **cim_kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 90)).astype(np.float32)
    w = _weights(6, 90, 11)
    jplan = jengine.plan_weights(jnp.asarray(w), jp.cim, jp)
    tplan = tengine.plan_weights(torch.from_numpy(w), tp.cim, tp)
    want = np.asarray(jengine.execute(jnp.asarray(x), jplan, jp))
    got = tengine.execute(torch.from_numpy(x), tplan, tp)
    assert got.shape == (3, 7, 11) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_execute_fp_backend_close():
    jp, tp = _policies("fp")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = _weights(7, 64, 9)
    want = np.asarray(jengine.execute(
        jnp.asarray(x), jengine.plan_weights(jnp.asarray(w), jp.cim, jp), jp))
    got = tengine.execute(
        torch.from_numpy(x),
        tengine.plan_weights(torch.from_numpy(w), tp.cim, tp), tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_backend_registry_and_aliases():
    assert tengine.backend_names() == ("behavioral", "cuda", "exact", "fp")
    assert tengine.get_backend("cim-kernel") is tengine.get_backend("cuda")
    assert tengine.get_backend("cim") is tengine.get_backend("behavioral")
    assert tengine.get_backend("cim-exact") is tengine.get_backend("exact")
    with pytest.raises(ValueError, match="reserved mode alias"):
        tengine.register_backend("cim-kernel", lambda *a: None)
    with pytest.raises(KeyError, match="unknown CIM backend"):
        tengine.get_backend("pallas")


def test_plan_params_walk():
    tree = {"fc": {"w": torch.randn(16, 4), "b": torch.zeros(4)},
            "bn": {"w": torch.ones(4)}, "scale": torch.ones(4)}
    _, tp = _policies("cim")
    out = tengine.plan_params(tree, tp.cim, tp)
    assert isinstance(out["fc"]["w"], tengine.PlannedWeights)
    assert out["fc"]["w"].planes is not None  # behavioral keeps planes
    assert out["fc"]["b"] is tree["fc"]["b"]
    assert out["bn"]["w"] is tree["bn"]["w"]  # 1-D: not a matmul weight
    assert out["scale"] is tree["scale"]


# ---------------------------------------------------------------------------
# Dispatch: resolution order, logging, guard fallback
# ---------------------------------------------------------------------------


def _codes(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 16, (m, k)).astype(np.int32)),
            torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)))


def test_only_p8t_backends_registered():
    # Slice 2 registers the two variant macros beside the P-8T one.
    for variant in ("p8t", "adder-tree", "cell-adc"):
        assert dispatch.backends_for(variant) == ("scan", "ref", "slots",
                                                  "cuda")
        assert dispatch.has_kernel(variant)
    assert {k.variant for k in dispatch._TABLE} == {"p8t", "adder-tree",
                                                   "cell-adc"}
    assert dispatch.shape_cell(1000, 144, 16) == (1024, 256, 16)
    assert dispatch.shape_cell(1 << 20, 3, 1) == (8192, 4, 1)


@pytest.mark.parametrize("backend", ["scan", "ref", "cuda"])
def test_explicit_backends_agree_and_are_logged(backend):
    x, w = _codes(9, 100, 7)
    cfg = TConfig()
    with dispatch.record_resolutions() as log:
        got = dispatch.dispatch(x, w, cfg, backend=backend)
    assert [(r.key.variant, r.key.backend, r.source) for r in log] == [
        ("p8t", backend, "explicit")]
    np.testing.assert_array_equal(
        got.numpy(), cim_mac.gpq_matmul_plain(x, w, cfg).numpy())


def test_heuristic_on_cpu_takes_scan_or_slots():
    x, w = _codes(40, 32, 3)
    cfg = TConfig()
    slots = torch.zeros((2, 16, 9))
    with dispatch.record_resolutions() as log:
        dispatch.dispatch(x, w, cfg)
        dispatch.dispatch(x[:8], w, cfg, slots=slots)
        dispatch.dispatch(x[:8], w, cfg.replace(rows_active=8), slots=slots)
    assert [(r.key.backend, r.source) for r in log] == [
        ("scan", "heuristic"), ("slots", "heuristic"), ("scan", "heuristic")]


def test_noise_request_routes_to_scan_and_raises():
    """A noisy spec with a generator routes an implicit pick to the scan
    (source "noise"), which draws from the generator; an explicit
    noiseless backend (ref, slots, cuda) raises rather than drop it."""
    x, w = _codes(4, 16, 2)
    cfg = TConfig(noisy=True)
    with dispatch.record_resolutions() as log:
        a = dispatch.dispatch(x, w, cfg,
                              generator=torch.Generator().manual_seed(3))
        b = dispatch.dispatch(x, w, cfg,
                              generator=torch.Generator().manual_seed(3))
    assert [(r.key.backend, r.source) for r in log] == [("scan", "noise")] * 2
    assert torch.equal(a, b)
    assert torch.equal(a, tmatmul.cim_matmul_int(
        x, w, cfg, generator=torch.Generator().manual_seed(3)))
    for backend in ("ref", "cuda"):
        with pytest.raises(ValueError, match="noiseless"):
            dispatch.dispatch(x, w, cfg, backend=backend,
                              generator=torch.Generator())


def test_implicit_kernel_depth_guard_falls_back_and_is_recorded(monkeypatch):
    monkeypatch.setattr(dispatch, "_heuristic_backend",
                        lambda *a, **k: "cuda")
    k = 4096 * 16
    x = torch.ones((1, k), dtype=torch.int32)
    w = torch.ones((k, 1), dtype=torch.int8)
    cfg = TConfig()
    with dispatch.record_resolutions() as log:
        got = dispatch.dispatch(x, w, cfg)
    assert [(r.key.backend, r.source) for r in log] == [
        ("cuda", "heuristic"), ("scan", "guard-fallback")]
    assert got.shape == (1, 1)
    with pytest.raises(ValueError, match="too deep"):
        dispatch.dispatch(x, w, cfg, backend="cuda")  # explicit: loud


@pytest.mark.parametrize("variant", ["p8t", "cell-adc", "adder-tree"])
@pytest.mark.parametrize("kw", [dict(act_bits=9),
                                dict(rows_per_group=64, rows_active=48)],
                         ids=["act_bits9", "rows48"])
def test_implicit_kernel_spec_refusal_falls_back_and_is_recorded(
        monkeypatch, variant, kw):
    """Where B1/B2/B3 refuse the operating point on the card, an implicit
    pick runs the scan (recorded as "spec-fallback") and an explicit
    request raises, with no launch either way."""
    monkeypatch.setattr(dispatch, "_heuristic_backend",
                        lambda *a, **k: "cuda")
    monkeypatch.setattr(cim_mac, "_on_cpu", lambda x, w: False)  # the card
    rng = np.random.default_rng(1)
    cfg = TConfig(**kw)
    x = torch.from_numpy(
        rng.integers(0, 1 << cfg.act_bits, (5, 100)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-128, 128, (100, 3)).astype(np.int8))
    before = sum(cim_mac.LAUNCHES.values())
    with dispatch.record_resolutions() as log:
        got = dispatch.dispatch(x, w, cfg, variant=variant)
    assert [(r.key.backend, r.source) for r in log] == [
        ("cuda", "heuristic"), ("scan", "spec-fallback")]
    want = dispatch.dispatch(x, w, cfg, variant=variant, backend="scan")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(cim_mac.KernelSpecError):
        dispatch.dispatch(x, w, cfg, variant=variant, backend="cuda")
    assert sum(cim_mac.LAUNCHES.values()) == before


def test_implicit_kernel_other_errors_propagate(monkeypatch):
    monkeypatch.setattr(dispatch, "_heuristic_backend",
                        lambda *a, **k: "cuda")

    def broken(*a, **k):
        raise ValueError("operand contract")

    impl = dispatch.lookup("p8t", "cuda")
    monkeypatch.setitem(dispatch._TABLE, dispatch.KernelKey("p8t", "cuda"),
                        dispatch.KernelImpl(fn=broken, is_kernel=True,
                                            supports_planes=True))
    x, w = _codes(2, 16, 2)
    with pytest.raises(ValueError, match="operand contract"):
        dispatch.dispatch(x, w, TConfig())
    assert impl is not None


def test_unknown_backend_and_slots_contract():
    x, w = _codes(2, 16, 2)
    with pytest.raises(KeyError, match="no kernel registered"):
        dispatch.dispatch(x, w, TConfig(), backend="pallas")
    with pytest.raises(ValueError, match="spread-slot operand"):
        dispatch.dispatch(x, w, TConfig(), backend="slots")


def test_cuda_backend_flatten_slices_packed_planes():
    x, w = _codes(6, 50, 5)
    cfg = TConfig(rows_active=8)
    planes = tengine._grouped_planes(w.to(torch.int32), TConfig(),
                                     packed=True)  # grouped at 16 rows
    got = dispatch.dispatch(x, w, cfg, backend="cuda", planes=planes)
    np.testing.assert_array_equal(
        got.numpy(), cim_mac.gpq_matmul_plain(x, w, cfg).numpy())
