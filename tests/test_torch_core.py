"""repro_torch.core against the JAX reference (repro.core), on the CPU.

Inputs come from numpy seeds and go to both packages. Every comparison
here is bit-exact: the operating-point records are plain Python, and the
quantizers, planes, slots and the integer macro transfers compute the
same float32/int32 values step for step (ties to even in both, f32
true division in both, exact integer sums).
"""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import matmul as jmatmul
from repro.core import pipeline as jpipeline
from repro.core import quant as jquant
from repro.core.engine import _grouped_planes as j_grouped_planes
from repro.core.params import CIMConfig as JConfig
from repro_torch.core import adc as tadc
from repro_torch.core import matmul as tmatmul
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import quant as tquant
from repro_torch.core.engine import _grouped_planes as t_grouped_planes
from repro_torch.core.params import PAPER_OP_8ROWS, PAPER_OP_16ROWS
from repro_torch.core.params import CIMConfig as TConfig

CERT = (pathlib.Path(__file__).resolve().parent.parent
        / "results" / "analysis" / "range-certificate.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geometry_kwargs():
    geos = json.loads(CERT.read_text())["geometries"]
    out = []
    for g in geos.values():
        out.append(pytest.param(dict(
            rows_per_group=g["rows_per_group"], rows_active=g["rows_active"],
            act_bits=g["act_bits"], weight_bits=g["weight_bits"],
            adc_bits=g["adc_bits"], cutoff=g["cutoff"],
            adc_coarse_bits=g["coarse_bits"],
        ), id=g["ident"]))
    # 16 rows at cutoff 0.25: threshold 192, a 4-bit ADC step of 12 --
    # the one point here whose step is not a power of two.
    out.append(pytest.param(dict(rows_active=16, cutoff=0.25, adc_bits=4),
                            id="step12/r16/cut0.25/adc4"))
    return out


GEOMETRIES = _geometry_kwargs()

_FIELDS = (
    "rows_per_group", "rows_active", "act_bits", "weight_bits", "adc_bits",
    "cutoff", "adc_mode", "adc_coarse_bits", "vdd", "sigma_dac_mv",
    "sigma_cmp_mv", "c_abl_ratio", "noisy", "macro_rows", "macro_cols",
    "n_ref_cols", "act_levels", "act_max", "pmac_max", "pmac_levels",
    "q_full", "threshold", "adc_step", "adc_codes", "share_denom",
    "sigma_pmac", "n_weight_cols", "n_outputs", "macs_per_cycle",
    "comparator_count",
)


def test_certificate_has_27_geometries():
    assert len(GEOMETRIES) == 28  # 27 certified + the step-12 point


@pytest.mark.parametrize("kw", GEOMETRIES)
@pytest.mark.parametrize("mode", ["floor", "nearest"])
def test_params_and_spec_fields_equal(kw, mode):
    jc, tc = JConfig(adc_mode=mode, **kw), TConfig(adc_mode=mode, **kw)
    js, ts = jpipeline.as_spec(jc), tpipeline.as_spec(tc)
    for f in _FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
        assert getattr(ts, f) == getattr(js, f), f
    assert tc.codes_dtype == torch.int8 and ts.codes_dtype == torch.int8
    assert ts.to_config() == tc and tc.to_spec() == ts
    for part in ("dac", "amu", "adc"):
        assert (dataclasses.asdict(getattr(ts, part))
                == dataclasses.asdict(getattr(js, part)))


def test_paper_points_and_spec_replace():
    assert PAPER_OP_16ROWS.threshold == 128 and PAPER_OP_16ROWS.adc_step == 8
    assert PAPER_OP_8ROWS.rows_active == 8
    assert tpipeline.PAPER_MACRO_16ROWS.to_config() == PAPER_OP_16ROWS
    assert tpipeline.PAPER_MACRO_8ROWS.to_config() == PAPER_OP_8ROWS
    ts = tpipeline.PAPER_MACRO_16ROWS.replace(adc_bits=5, rows_active=8,
                                              vdd=0.7)
    js = jpipeline.PAPER_MACRO_16ROWS.replace(adc_bits=5, rows_active=8,
                                              vdd=0.7)
    for f in _FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    with pytest.raises(ValueError):
        TConfig(rows_active=17)
    assert TConfig(weight_bits=9).codes_dtype == torch.int32


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


def _acts(rng, shape, signed):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.01] *= 8.0  # outliers the clip should cut
    return x if signed else np.maximum(x, 0.0)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("clip_pct", [1.0, 0.995, 0.9])
@pytest.mark.parametrize("per_token", [False, True])
def test_quantize_acts_bit_exact(symmetric, clip_pct, per_token):
    rng = np.random.default_rng(1)
    x = _acts(rng, (37, 53), signed=not symmetric)
    jq = jquant.quantize_acts(jnp.asarray(x), 4, symmetric=symmetric,
                              per_token=per_token, clip_pct=clip_pct)
    tq = tquant.quantize_acts(torch.from_numpy(x), 4, symmetric=symmetric,
                              per_token=per_token, clip_pct=clip_pct)
    for jv, tv in zip(jq, tq, strict=True):
        assert tv.shape == tuple(jv.shape)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tq.codes.dtype == torch.int32 and tq.zero_point.dtype == torch.int32


@pytest.mark.parametrize("n", [2, 3, 1000, 4097, 37 * 144])
def test_percentile_matches_jnp(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) * 3
    for q in (99.5, 0.5, 50.0, 99.9, 12.345):
        want = np.asarray(jnp.percentile(jnp.asarray(x), q, keepdims=True))
        (got,) = tquant.percentile(torch.from_numpy(x), (q,), (0,))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"q={q}")


def test_percentile_above_2_pow_24_elements():
    """torch.quantile refuses this size; the port's percentile must not,
    and must still equal jnp.percentile (the stage-0 im2col at batch 256
    is 37.7 M elements)."""
    n = (1 << 24) + 4097  # n and n - 1 both round in float32
    rng = np.random.default_rng(7)
    # Ascending without a sort (both libraries sort presorted data fast).
    x = np.cumsum(rng.random(n, dtype=np.float32), dtype=np.float32)
    (hi,) = tquant.percentile(torch.from_numpy(x), (99.5,), (0,))
    want = np.asarray(jnp.percentile(jnp.asarray(x), 99.5, keepdims=True))
    np.testing.assert_array_equal(hi.numpy(), want)


@pytest.mark.parametrize("weight_bits", [4, 8])
def test_quantize_weights_planes_bit_exact(weight_bits):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((3, 45, 11)) * 0.1).astype(np.float32)
    jq = jquant.quantize_weights(jnp.asarray(w), weight_bits)
    tq = tquant.quantize_weights(torch.from_numpy(w), weight_bits)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    codes = np.array(jq.codes)  # writable, for torch.from_numpy
    jp = jquant.bitslice_weights(jnp.asarray(codes), weight_bits)
    tp = tquant.bitslice_weights(torch.from_numpy(codes), weight_bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tquant.unslice_weights(tp, weight_bits).numpy(), codes)
    np.testing.assert_array_equal(
        tquant.plane_signs(weight_bits).numpy(),
        np.asarray(jquant.plane_signs(weight_bits)))


@pytest.mark.parametrize("kw", GEOMETRIES[::3] + GEOMETRIES[-1:])
def test_slots_and_grouped_planes_bit_exact(kw):
    cfg_j, cfg_t = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(3)
    codes = rng.integers(-128, 128, (70, 9)).astype(np.int32)
    rows = cfg_t.rows_active
    assert tquant.slot_spec(rows, 4, 8) == tuple(jquant.slot_spec(rows, 4, 8))
    js = jquant.spread_slots(jnp.asarray(codes), rows, 4, 8)
    ts = tquant.spread_slots(torch.from_numpy(codes), rows, 4, 8)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for packed in (False, True):
        jp = j_grouped_planes(jnp.asarray(codes), cfg_j, packed=packed)
        tp = t_grouped_planes(torch.from_numpy(codes), cfg_t, packed=packed)
        assert str(tp.dtype).removeprefix("torch.") == jp.dtype.name
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


# ---------------------------------------------------------------------------
# ADC transfer and the integer macro matmuls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", GEOMETRIES[::3] + GEOMETRIES[-1:])
@pytest.mark.parametrize("mode", ["floor", "nearest"])
def test_adc_transfer_bit_exact(kw, mode):
    jc, tc = JConfig(adc_mode=mode, **kw), TConfig(adc_mode=mode, **kw)
    pmac = np.arange(-3, tc.pmac_max + 20, dtype=np.int32)
    jcode = jadc.adc_transfer_int(jnp.asarray(pmac), jc)
    tcode = tadc.adc_transfer_int(torch.from_numpy(pmac), tc)
    np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(tadc.adc_dequant(tcode, tc).numpy(),
                                  np.asarray(jadc.adc_dequant(jcode, jc)))


def test_noisy_adc_request_raises_naming_the_slice():
    """Since slice 4 a noisy request draws from its generator: no
    generator is noiseless, as the reference without a key; one seed
    gives one draw; a generator on another device than the tensor
    raises, naming both."""
    cfg = TConfig(noisy=True)
    pmac = torch.arange(4096) % 200
    quiet = tadc.adc_transfer_int(pmac, cfg)
    assert torch.equal(quiet, tadc.adc_transfer_int(pmac, TConfig()))
    a = tadc.adc_transfer_int(pmac, cfg,
                              generator=torch.Generator().manual_seed(1))
    b = tadc.adc_transfer_int(pmac, cfg,
                              generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, quiet)

    class _Elsewhere:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="cuda generator"):
        tadc.adc_transfer_int(pmac, cfg, generator=_Elsewhere())


def _codes(rng, m, k, n, weight_bits=8):
    x = rng.integers(0, 16, (m, k)).astype(np.int32)
    lo, hi = -(1 << (weight_bits - 1)), 1 << (weight_bits - 1)
    w = rng.integers(lo, hi, (k, n)).astype(np.int32)
    return x, w


@pytest.mark.parametrize("layout", ["codes", "unpacked", "packed"])
@pytest.mark.parametrize("kw", [GEOMETRIES[1], GEOMETRIES[13],
                                GEOMETRIES[-1]])
@pytest.mark.parametrize("mode", ["floor", "nearest"])
def test_scan_twin_bit_exact(layout, kw, mode):
    jc, tc = JConfig(adc_mode=mode, **kw), TConfig(adc_mode=mode, **kw)
    rng = np.random.default_rng(4)
    x, w = _codes(rng, 9, 100, 7)
    jplanes = tplanes = None
    if layout != "codes":
        packed = layout == "packed"
        jplanes = j_grouped_planes(jnp.asarray(w), jc, packed=packed)
        tplanes = t_grouped_planes(torch.from_numpy(w), tc, packed=packed)
    want = jmatmul.cim_matmul_int(jnp.asarray(x), jnp.asarray(w), jc,
                                  planes=jplanes)
    got = tmatmul.cim_matmul_int(torch.from_numpy(x), torch.from_numpy(w),
                                 tc, planes=tplanes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_int_matches_int32_dot():
    rng = np.random.default_rng(5)
    # Deep enough that a float32 product of these codes would round.
    x = rng.integers(0, 16, (4, 40000)).astype(np.int32)
    w = rng.integers(-128, 128, (40000, 3)).astype(np.int32)
    want = jmatmul.cim_matmul_exact_int(jnp.asarray(x), jnp.asarray(w))
    got = tmatmul.cim_matmul_exact_int(torch.from_numpy(x),
                                       torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_true_divide_is_correctly_rounded():
    x = torch.arange(0, 241, dtype=torch.float32)
    np.testing.assert_array_equal(
        tquant.true_divide(x, 12.0).numpy(),
        (x.numpy().astype(np.float64) / 12.0).astype(np.float32))
