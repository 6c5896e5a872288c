"""repro_torch.core.{dac,adc,pipeline,macro,variants} and the adder-tree
formulations against the JAX reference, on the CPU. (B2's and B3's
kernel wrappers are held to the reference's Pallas kernels in
tests/test_torch_kernels.py.)

Every integer path is held bit for bit: merged values and codes are exact
integers in float32, and the reference runs eagerly (its jitted programs
rewrite divisions by constants into reciprocal products). Voltages are
float32 values computed in another summation order than XLA's, so they
are held to 1e-6 V; the codes read from them are held exactly (the ADC's
tie-break epsilon is far above that difference).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import calibrate as jcal
from repro.core import dac as jdac
from repro.core import variants as jvariants
from repro.core.params import CIMConfig as JConfig
from repro.kernels import ref as jref
from repro_torch.core import adc as tadc
from repro_torch.core import calibrate as tcal
from repro_torch.core import dac as tdac
from repro_torch.core import variants as tvariants
from repro_torch.core.engine import _grouped_planes
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.core.quant import spread_slots
from repro_torch.kernels import cim_mac, dispatch
from repro_torch.kernels import ref as tref

VARIANTS = ("p8t", "adder-tree", "cell-adc")
# rows {4, 8, 16} x ADC bits {3, 4, 5} at cutoff 0.5 (with the three
# variants: the 27 certified geometries), plus the step-12 point.
GRID = [dict(rows_active=r, adc_bits=a, cutoff=0.5)
        for r in (4, 8, 16) for a in (3, 4, 5)]
GRID.append(dict(rows_active=16, adc_bits=4, cutoff=0.25))
GRID_IDS = [f"r{g['rows_active']}-adc{g['adc_bits']}-cut{g['cutoff']}"
            for g in GRID]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 16, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return x, w


def _spec_fields(spec) -> dict:
    return dataclasses.asdict(spec.to_config())


# ---------------------------------------------------------------------------
# Records: merged quantization, costs and geometry of every variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_merged_quant_costs_and_specs_match_reference(kw):
    jc, tc = JConfig(**kw), TConfig(**kw)
    assert dataclasses.asdict(tvariants.merged_quant(tc)) == \
        dataclasses.asdict(jvariants.merged_quant(jc))
    assert tvariants.merged_quant(tc).levels == \
        jvariants.merged_quant(jc).levels
    assert tvariants.merged_sigma(tc) == jvariants.merged_sigma(jc)
    for name in VARIANTS:
        tv, jv = tvariants.get(name), jvariants.get(name)
        assert (tv.per_plane_adc, tv.flash_split) == \
            (jv.per_plane_adc, jv.flash_split)
        assert tv.hw_cost(tc) == jv.hw_cost(jc)
        assert _spec_fields(tv.adapt_spec(tc)) == \
            _spec_fields(jv.adapt_spec(jc))
        assert _spec_fields(tv.anchor_spec(tc)) == \
            _spec_fields(jv.anchor_spec(jc))


def test_registry():
    assert tvariants.names() == jvariants.names() == tuple(sorted(VARIANTS))
    assert tvariants.get("cell-adc").adapt_spec(TConfig()).n_outputs == 10
    with pytest.raises(KeyError, match="unknown macro variant"):
        tvariants.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        tvariants.register(tvariants.P8T)


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_merged_transfer_exact_on_step_multiples(kw, mode):
    """Codes at every exact multiple of the step across the code range,
    negative ones included, and one either side of each."""
    jc, tc = JConfig(adc_mode=mode, **kw), TConfig(adc_mode=mode, **kw)
    mq = tvariants.merged_quant(tc)
    mult = np.arange(mq.code_min - 2, mq.code_max + 3) * mq.step
    vals = np.unique(np.concatenate([mult - 1, mult, mult + 1]))
    vals = vals[(vals >= mq.m_min) & (vals <= mq.m_max)].astype(np.float32)
    want = np.asarray(jvariants.merged_transfer_int(jnp.asarray(vals), jc))
    got = tvariants.merged_transfer_int(torch.from_numpy(vals), tc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tvariants.merged_dequant(got, tc).numpy(),
        np.asarray(jvariants.merged_dequant(jnp.asarray(want), jc)))


def test_noise_requests_raise_naming_slice_4():
    """Since slice 4 every noise request draws from its generator and is
    reproducible under a fixed seed (the statistics against the reference
    are in tests/test_torch_noise.py); a generator on another device than
    the tensors still raises."""
    noisy = TConfig(noisy=True)
    x, w = _codes(0, 2, 16, 2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    runs = (
        lambda g: tvariants.merged_transfer_int(torch.zeros(64), noisy,
                                                generator=g),
        lambda g: tvariants.adder_tree_matmul_int(tx, tw, noisy,
                                                  generator=g),
        lambda g: tadc.adc_read_voltage(torch.full((64,), 0.5), noisy,
                                        generator=g),
        *(lambda g, name=name: tvariants.get(name).pipeline.run(
            tx[0], tw, noisy, generator=g).outputs for name in VARIANTS),
    )
    for run in runs:
        a = run(torch.Generator().manual_seed(5))
        assert torch.equal(a, run(torch.Generator().manual_seed(5)))

    class _Elsewhere:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="cuda generator"):
        runs[0](_Elsewhere())


# ---------------------------------------------------------------------------
# Voltage domain: DAC, references, flash and SAR readouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_references_and_flash_readout_match_reference(kw):
    jc, tc = JConfig(**kw), TConfig(**kw)
    codes = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(
        tdac.cap_states(torch.from_numpy(codes), tc).numpy(),
        np.asarray(jdac.cap_states(jnp.asarray(codes), jc)))
    np.testing.assert_array_equal(
        tdac.dac_voltage(torch.from_numpy(codes), tc).numpy(),
        np.asarray(jdac.dac_voltage(jnp.asarray(codes), jc)))
    if tc.threshold % tc.adc_codes:  # step 12 is not a reference spacing
        with pytest.raises(ValueError, match="integer pMAC spacing"):
            tadc.reference_patterns(tc)
        return
    assert tadc.reference_patterns(tc) == jadc.reference_patterns(jc)
    np.testing.assert_allclose(
        tadc.reference_voltages(tc).numpy(),
        np.asarray(jadc.reference_voltages(jc)), rtol=0, atol=1e-6)
    pmac = np.arange(tc.pmac_levels, dtype=np.float32)
    v = jdac.abl_voltage_from_pmac(jnp.asarray(pmac), jc)
    tv = tdac.abl_voltage_from_pmac(torch.from_numpy(pmac), tc)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=0, atol=1e-6)
    want = np.asarray(jadc.adc_transfer_int(jnp.asarray(pmac), jc))
    for coarse in range(tc.adc_bits + 1):
        got = tadc.adc_read_voltage(tv, tc, coarse_bits=coarse)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tadc.adc_flat_flash(tv, tc).numpy(), want)
    np.testing.assert_array_equal(
        tdac.pmac_from_abl_voltage(tv, tc).round().numpy(), pmac)


def test_reference_patterns_raise_beyond_the_arrays_range():
    """Cutoff 0 at full resolution: the top level needs 255 units of
    reference charge from 16 arrays of at most 15."""
    jc, tc = JConfig(cutoff=0.0, adc_bits=8), TConfig(cutoff=0.0, adc_bits=8)
    with pytest.raises(ValueError, match="not representable"):
        jadc.reference_patterns(jc)
    with pytest.raises(ValueError, match="not representable"):
        tadc.reference_patterns(tc)
    # 5-bit at 16 rows reprograms with heterogeneous per-row codes.
    jc5, tc5 = JConfig(adc_bits=5), TConfig(adc_bits=5)
    assert tadc.reference_patterns(tc5) == jadc.reference_patterns(jc5)


@pytest.mark.parametrize("kw", GRID[:9], ids=GRID_IDS[:9])
def test_pipelines_equal_their_oracles_and_reference(kw):
    """Each variant's voltage-domain pipeline equals its integer oracle
    with noise off, and both equal the reference's oracle."""
    jc, tc = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(kw["rows_active"] * 10 + kw["adc_bits"])
    for trial in range(6):
        x = rng.integers(0, 16, 16).astype(np.int32)
        if trial == 0:
            x[:] = 15  # the saturating corner
        w = rng.integers(-128, 128, (16, 8)).astype(np.int8)
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
        for name in VARIANTS:
            tv = tvariants.get(name)
            state = tv.pipeline.run(tx, tw, tc)
            oracle = tv.oracle_int(tx, tw, tc)
            np.testing.assert_array_equal(state.outputs.numpy(),
                                          oracle.numpy(), err_msg=name)
            want = jvariants.get(name).oracle_int(jnp.asarray(x),
                                                  jnp.asarray(w), jc)
            np.testing.assert_array_equal(oracle.numpy(), np.asarray(want),
                                          err_msg=name)
        pmac = tvariants.get("p8t").pipeline.run(tx, tw, tc).pmac_ideal
        planes = ((w.astype(np.int32)[None] >> np.arange(8)[:, None, None])
                  & 1)
        x_act = np.where(np.arange(16) < tc.rows_active, x, 0)
        np.testing.assert_array_equal(
            pmac.numpy(), np.einsum("r,bro->ob", x_act, planes))


# Rows 4/8/16 and ADC bits 3/4/5 each appear; the reference's voltage-
# domain table costs about a second per geometry here.
TABLE_GRID = [GRID[0], GRID[4], GRID[7], GRID[8]]


@pytest.mark.parametrize("kw", TABLE_GRID,
                         ids=[GRID_IDS[i] for i in (0, 4, 7, 8)])
def test_adc_code_tables_match_reference(kw):
    jc, tc = JConfig(**kw), TConfig(**kw)
    for name in ("p8t", "cell-adc"):
        got = tcal.adc_code_table(tvariants.get(name).pipeline, tc)
        want = jcal.adc_code_table(jvariants.get(name).pipeline, jc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)


def test_adc_code_tables_equal_the_floor_transfer():
    """The ideal transfer of both per-plane pipelines is the flash floor
    (what lets the calibrated backend dispatch them to the kernels)."""
    for kw in GRID[:9]:
        tc = TConfig(**kw)
        floor = tadc.adc_transfer_int(
            torch.arange(tc.pmac_levels, dtype=torch.float32), tc)
        for name in ("p8t", "cell-adc"):
            got = tcal.adc_code_table(tvariants.get(name).pipeline, tc)
            np.testing.assert_array_equal(got.numpy(), floor.numpy(),
                                          err_msg=f"{name} {kw}")


# ---------------------------------------------------------------------------
# The adder-tree matmul: scan twin, ref, slots, dispatch and B2's plain form
# ---------------------------------------------------------------------------

SHAPES = [(1, 16, 1), (9, 144, 16), (13, 35, 70)]


@pytest.mark.parametrize("mode", ["floor", "nearest"])
@pytest.mark.parametrize("gi", [1, 5, len(GRID) - 1],
                         ids=[GRID_IDS[1], GRID_IDS[5], GRID_IDS[-1]])
def test_adder_tree_formulations_match_reference(gi, mode):
    jc, tc = JConfig(adc_mode=mode, **GRID[gi]), \
        TConfig(adc_mode=mode, **GRID[gi])
    for m, k, n in SHAPES:
        x, w = _codes(m * k + n, m, k, n)
        want = np.asarray(jref.adder_tree_matmul_ref(jnp.asarray(x),
                                                     jnp.asarray(w), jc))
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
        unpacked = _grouped_planes(tw.to(torch.int32), tc, packed=False)
        packed = _grouped_planes(tw.to(torch.int32), tc, packed=True)
        slots = spread_slots(tw.to(torch.int32), tc.rows_active, 4, 8)
        got = {
            "scan": tvariants.adder_tree_matmul_int(tx, tw, tc),
            "ref": tref.adder_tree_matmul_ref(tx, tw, tc),
            "slots": tref.adder_tree_matmul_slots(tx, slots, tc),
            "plain": cim_mac.adder_tree_gpq_matmul_plain(tx, tw, tc),
        }
        for name, planes in (("unpacked", unpacked), ("packed", packed)):
            got[f"scan-{name}"] = tvariants.adder_tree_matmul_int(
                tx, tw, tc, planes=planes)
            got[f"ref-{name}"] = tref.adder_tree_matmul_ref(
                tx, tw, tc, planes=planes)
            for backend in ("scan", "ref", "cuda"):
                got[f"dispatch-{backend}-{name}"] = dispatch.dispatch(
                    tx, tw, tc, variant="adder-tree", backend=backend,
                    planes=planes)
        got["dispatch-slots"] = dispatch.dispatch(
            tx, tw, tc, variant="adder-tree", backend="slots", slots=slots)
        for name, y in got.items():
            assert y.dtype == torch.float32, name
            np.testing.assert_array_equal(y.numpy(), want,
                                          err_msg=f"{name} {(m, k, n)}")
