"""Hardware noise in repro_torch (slice 4) against the JAX reference, on
the CPU: ``core.noise``'s Monte-Carlo studies, the voltage-domain
``macro_op`` and every noisy transfer (DAC, flash comparators, the
integer ADC, the merged single ADC, the cell-embedded SAR, the scan
twins and the calibrated table path).

Noiseless paths are held bit for bit (codes, outputs) and voltages to
1e-6 V, as in tests/test_torch_variants.py. torch cannot replay
``jax.random``, so noisy paths are held by statistics over seeds, the
tolerance of each written beside it:

* a rate p from n_t and n_j samples (code-error rates): |p_t - p_j| <=
  5 sqrt(p (1 - p) (1/n_t + 1/n_j)) + 2e-3, p pooled;
* a mean over n draws of variance v each: 5 sqrt(v/n_t + v/n_j);
* a standard deviation from n draws: relative 5 sqrt(1/(2 n)) x sqrt(2),
  each side's estimate carrying sqrt(1/(2 n)) relative error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import calibrate as jcal
from repro.core import macro as jmacro
from repro.core import noise as jnoise
from repro.core import variants as jvariants
from repro.core.params import CIMConfig as JConfig
from repro.core.pipeline import MacroState as JState
from repro_torch.core import adc as tadc
from repro_torch.core import calibrate as tcal
from repro_torch.core import dac as tdac
from repro_torch.core import macro as tmacro
from repro_torch.core import noise as tnoise
from repro_torch.core import variants as tvariants
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.core.pipeline import MacroState as TState
from repro_torch.kernels import dispatch

VARIANTS = ("p8t", "adder-tree", "cell-adc")
# Rows {4, 8, 16} x ADC bits {3, 4, 5} on the diagonal, and the paper
# point (the pipelines' full grid is held in tests/test_torch_variants.py).
GRID = [dict(rows_active=r, adc_bits=a)
        for r, a in ((4, 3), (8, 4), (16, 5), (16, 4))]
GRID_IDS = [f"r{g['rows_active']}-adc{g['adc_bits']}" for g in GRID]
# The noisy operating point of the statistics: the paper's 16-row, 4-bit
# point at 0.6 V (the worst-case sigmas).
NOISY = dict(noisy=True, vdd=0.6)


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


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _rates_agree(pt, pj, nt, nj):
    pt, pj = np.asarray(pt, np.float64), np.asarray(pj, np.float64)
    p = (pt * nt + pj * nj) / (nt + nj)
    tol = 5 * np.sqrt(p * (1 - p) * (1 / nt + 1 / nj)) + 2e-3
    bad = np.abs(pt - pj) > tol
    assert not bad.any(), (np.flatnonzero(bad), pt[bad], pj[bad], tol[bad])


def _means_agree(mt, mj, var, nt, nj):
    tol = 5 * np.sqrt(var / nt + var / nj)
    assert np.all(np.abs(np.asarray(mt) - np.asarray(mj)) <= tol), \
        (mt, mj, tol)


def _stds_agree(st, sj, n):
    rel = 5 * np.sqrt(2) * np.sqrt(1 / (2 * n))
    st, sj = np.asarray(st, np.float64), np.asarray(sj, np.float64)
    assert np.all(np.abs(st - sj) <= rel * np.maximum(st, sj)), (st, sj)


# ---------------------------------------------------------------------------
# Noiseless: the voltage-domain macro op, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_macro_op_matches_reference_noiseless(kw):
    jc, tc = JConfig(**kw), TConfig(**kw)
    x, w = _codes(1, 2, 16, 8)
    for i in range(x.shape[0]):
        want = jmacro.macro_op(jnp.asarray(x[i]), jnp.asarray(w), jc)
        got = tmacro.macro_op(torch.from_numpy(x[i]), torch.from_numpy(w),
                              tc)
        oracle = tmacro._macro_op_oracle(torch.from_numpy(x[i]),
                                         torch.from_numpy(w), tc)
        for name in ("outputs", "adc_codes", "pmac_ideal"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
            assert torch.equal(getattr(got, name), getattr(oracle, name))
        np.testing.assert_allclose(got.v_abl.numpy(), np.asarray(want.v_abl),
                                   rtol=0, atol=1e-6)
        assert got.adc_codes.dtype == got.pmac_ideal.dtype == torch.int32
        for v in VARIANTS:
            pipe = tvariants.get_pipeline(v)
            assert pipe is tvariants.get(v).pipeline
            got_v = tmacro.macro_op(torch.from_numpy(x[i]),
                                    torch.from_numpy(w), tc, pipeline=pipe)
            want_v = jmacro.macro_op(jnp.asarray(x[i]), jnp.asarray(w), jc,
                                     pipeline=jvariants.get_pipeline(v))
            np.testing.assert_array_equal(got_v.outputs.numpy(),
                                          np.asarray(want_v.outputs))


def test_noisy_pipeline_equals_the_oracle_draw_for_draw():
    """With one seeded generator the default pipeline and the monolithic
    oracle draw the same errors in the same order: equal bit for bit."""
    tc = TConfig(**NOISY)
    x, w = _codes(2, 8, 16, 8)
    for i in range(x.shape[0]):
        a = tmacro.macro_op(torch.from_numpy(x[i]), torch.from_numpy(w), tc,
                            generator=_gen(i))
        b = tmacro._macro_op_oracle(torch.from_numpy(x[i]),
                                    torch.from_numpy(w), tc,
                                    generator=_gen(i))
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# The Monte-Carlo studies (paper Figs. 5b, 9a): port on the CPU against
# the reference, same sample counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vdd=0.6), dict(vdd=0.9, rows_active=8)],
                         ids=["paper-0.6V", "8rows-0.9V"])
def test_linearity_studies_match_reference(kw):
    n = 4000
    for study in ("mc_dac_linearity", "mc_accumulation_linearity"):
        t = getattr(tnoise, study)(TConfig(**kw), n_samples=n, seed=1,
                                   device="cpu")
        j = getattr(jnoise, study)(JConfig(**kw), n_samples=n, seed=1)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_allclose(t.ideal_v.numpy(), np.asarray(j.ideal_v),
                                   rtol=0, atol=1e-6)
        _stds_agree(t.std_v.numpy(), np.asarray(j.std_v), n)
        var = np.maximum(t.std_v.numpy(), np.asarray(j.std_v)) ** 2
        _means_agree(t.mean_v.numpy(), np.asarray(j.mean_v), var, n, n)
        # And both against the model: mean = ideal, std = the DAC sigma
        # (per row for the DAC; sqrt(rows) of them shared over 16 + kappa).
        cfg = TConfig(**kw)
        sigma = cfg.sigma_dac_mv * 1e-3 * cfg.vdd / 0.6
        if study == "mc_accumulation_linearity":
            sigma *= np.sqrt(cfg.rows_active) / (cfg.rows_per_group
                                                 + cfg.c_abl_ratio)
        _stds_agree(t.std_v.numpy(), np.full(16, sigma), n)
        _means_agree(t.mean_v.numpy(), t.ideal_v.numpy(), sigma ** 2, n, n)


@pytest.mark.parametrize("coarse", [0, 1, 2])
def test_adc_error_rate_studies_match_reference(coarse):
    n = 2048
    cfg_t, cfg_j = TConfig(**NOISY), JConfig(**NOISY)
    t = tnoise.mc_adc_split_error_rate(cfg_t, coarse, n_samples=n, seed=2,
                                       device="cpu")
    j = jnoise.mc_adc_split_error_rate(cfg_j, coarse, n_samples=n, seed=2)
    assert t.shape == (cfg_t.pmac_levels,)
    _rates_agree(t.numpy(), np.asarray(j), n, n)
    if coarse == 1:
        t = tnoise.mc_adc_error_rate(cfg_t, n_samples=n, seed=3,
                                     device="cpu")
        j = jnoise.mc_adc_error_rate(cfg_j, n_samples=n, seed=3)
        _rates_agree(t.numpy(), np.asarray(j), n, n)
        assert 0.0 < float(t.mean()) < 0.5  # noise moves codes, not all


def test_studies_are_deterministic_and_refuse_a_missing_device():
    cfg = TConfig(**NOISY)
    a = tnoise.mc_dac_linearity(cfg, n_samples=64, seed=4, device="cpu")
    b = tnoise.mc_dac_linearity(cfg, n_samples=64, seed=4, device="cpu")
    c = tnoise.mc_dac_linearity(cfg, n_samples=64, seed=5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.mean_v, c.mean_v)
    if not torch.cuda.is_available():  # the entry points default to cuda
        with pytest.raises((RuntimeError, AssertionError)):
            tnoise.mc_adc_error_rate(cfg, n_samples=8)


# ---------------------------------------------------------------------------
# Noisy transfers, by statistics over seeds
# ---------------------------------------------------------------------------


def test_noisy_integer_and_merged_transfers_match_reference():
    """The per-plane integer ADC and the merged single ADC: code-error
    rate against the noiseless code and the mean code shift, per input
    level, port against reference."""
    n = 1024
    cfg_t, cfg_j = TConfig(**NOISY), JConfig(**NOISY)
    pmac = np.arange(cfg_t.pmac_levels, dtype=np.float32)
    ideal = np.asarray(jadc.adc_transfer_int(jnp.asarray(pmac),
                                             JConfig(vdd=0.6)))
    tcodes = tadc.adc_transfer_int(torch.from_numpy(pmac).expand(n, -1),
                                   cfg_t, generator=_gen(6)).numpy()
    jcodes = np.asarray(jax.vmap(lambda k: jadc.adc_transfer_int(
        jnp.asarray(pmac), cfg_j, key=k))(_keys(n, 6)))
    _rates_agree((tcodes != ideal).mean(0), (jcodes != ideal).mean(0), n, n)
    _means_agree((tcodes - ideal).mean(0), (jcodes - ideal).mean(0),
                 1.0, n, n)
    # Merged values across the signed range, 16-row paper point.
    mq = tvariants.merged_quant(cfg_t)
    merged = np.linspace(mq.m_min, mq.m_max, 257).round().astype(np.float32)
    ideal = np.asarray(jvariants.merged_transfer_int(jnp.asarray(merged),
                                                     JConfig(vdd=0.6)))
    tcodes = tvariants.merged_transfer_int(
        torch.from_numpy(merged).expand(n, -1), cfg_t,
        generator=_gen(7)).numpy()
    jcodes = np.asarray(jax.vmap(lambda k: jvariants.merged_transfer_int(
        jnp.asarray(merged), cfg_j, key=k))(_keys(n, 7)))
    _rates_agree((tcodes != ideal).mean(0), (jcodes != ideal).mean(0), n, n)
    assert tvariants.merged_sigma(cfg_t) == jvariants.merged_sigma(cfg_j)


def test_noisy_comparator_readouts_match_reference():
    """Flash comparators (coarse-fine split 1) and the cell-embedded SAR
    (one offset per conversion): code-error rate per pMAC level."""
    n = 1024
    cfg_t, cfg_j = TConfig(**NOISY), JConfig(**NOISY)
    pmac = np.arange(cfg_t.pmac_levels, dtype=np.float32)
    v = tdac.abl_voltage_from_pmac(torch.from_numpy(pmac), cfg_t)
    jv = jnp.asarray(v.numpy())
    ideal = np.asarray(jadc.adc_transfer_int(jnp.asarray(pmac),
                                             JConfig(vdd=0.6)))
    t = tadc.adc_read_voltage(v.expand(n, -1), cfg_t,
                              generator=_gen(8)).numpy()
    j = np.asarray(jax.vmap(lambda k: jadc.adc_read_voltage(
        jv, cfg_j, key=k))(_keys(n, 8)))
    _rates_agree((t != ideal).mean(0), (j != ideal).mean(0), n, n)
    tstage = tvariants.CellADCStage()
    jstage = jvariants.CellADCStage()
    t = tstage(TState(v_abl=v.expand(n, -1).contiguous(), generator=_gen(9)),
               tvariants.get("cell-adc").adapt_spec(cfg_t)).adc_codes.numpy()
    jspec = jvariants.get("cell-adc").adapt_spec(cfg_j)
    j = np.asarray(jax.vmap(lambda k: jstage(
        JState(v_abl=jv, key_adc=k), jspec).adc_codes)(_keys(n, 9)))
    _rates_agree((t != ideal).mean(0), (j != ideal).mean(0), n, n)
    assert 0 < (t != ideal).mean() < 0.5


@pytest.mark.parametrize("variant", VARIANTS)
def test_noisy_macro_op_matches_reference(variant):
    """One macro cycle of each variant's pipeline (DAC errors per row,
    then the variant's ADC noise): per-output error mean and rate of
    outputs moved, over 256 seeds."""
    n = 256
    cfg_t, cfg_j = TConfig(**NOISY), JConfig(**NOISY)
    x, w = _codes(10, 1, 16, 8)
    tx, tw = torch.from_numpy(x[0]), torch.from_numpy(w)
    clean = tmacro.macro_op(tx, tw, TConfig(vdd=0.6),
                            pipeline=tvariants.get_pipeline(variant)).outputs
    t = np.stack([tmacro.macro_op(
        tx, tw, cfg_t, generator=_gen(100 + s),
        pipeline=tvariants.get_pipeline(variant)).outputs.numpy()
        for s in range(n)])
    pipe = jvariants.get_pipeline(variant)
    j = np.asarray(jax.vmap(lambda k: jmacro.macro_op(
        jnp.asarray(x[0]), jnp.asarray(w), cfg_j, key=k,
        pipeline=pipe).outputs)(_keys(n, 10)))
    c = clean.numpy()
    _rates_agree((t != c).mean(0), (j != c).mean(0), n, n)
    var = max(float(np.var(t - c)), float(np.var(j - c)), 1.0)
    _means_agree((t - c).mean(0), (j - c).mean(0), var, n, n)


@pytest.mark.parametrize("variant", VARIANTS)
def test_noisy_scan_twins_match_reference(variant):
    """The grouped scan transfer (variants_bench --smoke layer: M 32,
    K 64, N 8; noise per row group): mean and variance of the error
    against the noiseless output and the rate of outputs moved, over
    64 seeds; each seed's run is reproducible."""
    n = 64
    cfg_t, cfg_j = TConfig(**NOISY), JConfig(**NOISY)
    x, w = _codes(11, 32, 64, 8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tfn = tvariants.get(variant).matmul_int
    jfn = jvariants.get(variant).matmul_int
    clean = tfn(tx, tw, TConfig(vdd=0.6)).numpy()
    np.testing.assert_array_equal(
        clean, np.asarray(jfn(jnp.asarray(x), jnp.asarray(w),
                              JConfig(vdd=0.6))))
    t = np.stack([tfn(tx, tw, cfg_t, generator=_gen(200 + s)).numpy()
                  for s in range(n)])
    assert np.array_equal(t[0], tfn(tx, tw, cfg_t,
                                    generator=_gen(200)).numpy())
    j = np.asarray(jax.vmap(lambda k: jfn(jnp.asarray(x), jnp.asarray(w),
                                          cfg_j, key=k))(_keys(n, 11)))
    et, ej = (t - clean).ravel(), (j - clean).ravel()
    m = et.size
    _rates_agree((et != 0).mean(), (ej != 0).mean(), m, m)
    var = max(et.var(), ej.var())
    _means_agree(et.mean(), ej.mean(), var, m, m)
    _stds_agree(et.std(), ej.std(), m)


def test_noisy_table_path_matches_reference():
    """The calibrated table path (``_lut_matmul_int``): noise in the pMAC
    domain, rounded to a level before the lookup."""
    n = 64
    cfg_t, cfg_j = TConfig(**NOISY), JConfig(**NOISY)
    x, w = _codes(12, 32, 64, 8)
    table = tcal.adc_code_table(tvariants.get_pipeline("p8t"), cfg_t)
    jtable = jcal.adc_code_table(jvariants.get_pipeline("p8t"), cfg_j)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w).to(torch.int32)
    clean = tcal._lut_matmul_int(tx, tw, cfg_t, table, None).numpy()
    t = np.stack([tcal._lut_matmul_int(tx, tw, cfg_t, table,
                                       _gen(300 + s)).numpy()
                  for s in range(n)])
    j = np.asarray(jax.vmap(lambda k: jcal._lut_matmul_int(
        jnp.asarray(x), jnp.asarray(w, jnp.int32), cfg_j, jtable,
        k))(_keys(n, 12)))
    et, ej = (t - clean).ravel(), (j - clean).ravel()
    m = et.size
    _rates_agree((et != 0).mean(), (ej != 0).mean(), m, m)
    _stds_agree(et.std(), ej.std(), m)


# ---------------------------------------------------------------------------
# Routing: noise reaches the scan, noiseless requests the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_noise_routes_to_scan_and_noiseless_to_the_kernel(variant):
    """A noisy spec with a generator takes the scan with source "noise"
    (drawing from that generator); without noise the heuristic takes the
    variant's kernel for CUDA operands without unpacked planes."""
    x, w = _codes(13, 8, 64, 8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    cfg = TConfig(**NOISY)
    with dispatch.record_resolutions() as log:
        got = dispatch.dispatch(tx, tw, cfg, variant=variant,
                                generator=_gen(14))
    assert [(r.key.variant, r.key.backend, r.source) for r in log] == \
        [(variant, "scan", "noise")]
    want = tvariants.get(variant).matmul_int(tx, tw, cfg,
                                             generator=_gen(14))
    assert torch.equal(got, want)
    assert dispatch._heuristic_backend(
        variant, None, None, 4096, torch.device("cuda")) == "cuda"
    assert dispatch._heuristic_backend(
        variant, None, None, 4096, torch.device("cpu")) == "scan"
    with pytest.raises(ValueError, match="noiseless"):
        dispatch.dispatch(tx, tw, cfg, variant=variant, backend="cuda",
                          generator=_gen(14))


def test_dac_noise_scales_with_the_supply():
    """dac_voltage's sigma is sigma_dac_mv at 0.6 V, linear in vdd."""
    n = 20000
    for vdd in (0.6, 1.2):
        cfg = TConfig(noisy=True, vdd=vdd)
        v = tdac.dac_voltage(torch.full((n,), 5, dtype=torch.int32), cfg,
                             generator=_gen(15))
        want = cfg.sigma_dac_mv * 1e-3 * vdd / 0.6
        _stds_agree(float(v.std()), want, n)
