"""repro_torch.core.energy against the JAX reference: the analytical
energy model is pure Python in both packages, so every function must
return the reference's floats exactly (no tolerance), on the CPU."""

import dataclasses
import math

import pytest

from repro.core import energy as jenergy
from repro.core import variants as jvariants
from repro.core.params import CIMConfig as JConfig
from repro.core.pipeline import MacroSpec as JSpec
from repro_torch.core import energy as tenergy
from repro_torch.core import variants as tvariants
from repro_torch.core.params import CIMConfig as TConfig
from repro_torch.core.pipeline import MacroSpec as TSpec

VARIANTS = ("p8t", "adder-tree", "cell-adc")
VDDS = (0.48, 0.6, 0.75, 0.9, 1.0, 1.2, 1.5)
# Operating points: the paper's, every certified rows x bits point, a
# coarse split of 2, off-grid cutoffs and a narrow geometry.
POINTS = [dict()] + [
    dict(rows_active=r, adc_bits=b) for r in (4, 8, 16) for b in (3, 4, 5)
] + [dict(adc_coarse_bits=2), dict(cutoff=0.25), dict(cutoff=0.3),
     dict(weight_bits=4, rows_active=8, adc_bits=3)]


def test_fitted_constants_and_anchors_equal():
    assert tenergy.fitted_vt() == jenergy.fitted_vt()
    assert (tenergy._C0, tenergy._C1, tenergy._C2) == \
        (jenergy._C0, jenergy._C1, jenergy._C2)
    assert (tenergy._KF, tenergy._VT) == (jenergy._KF, jenergy._VT)
    assert tenergy.VARIANT_ANCHORS == jenergy.VARIANT_ANCHORS
    assert tenergy._ADC_ENERGY_SHARE == jenergy._ADC_ENERGY_SHARE
    assert tenergy.adc_energy_comparison() == \
        jenergy.adc_energy_comparison()


@pytest.mark.parametrize("vdd", VDDS)
def test_supply_curves_equal(vdd):
    assert tenergy.energy_per_cycle_j(vdd) == jenergy.energy_per_cycle_j(vdd)
    assert tenergy.frequency_mhz(vdd) == jenergy.frequency_mhz(vdd)
    assert tenergy.validate_vdd(vdd) == jenergy.validate_vdd(vdd)
    for v in VARIANTS:
        assert tenergy.variant_tops_per_w(vdd, v) == \
            jenergy.variant_tops_per_w(vdd, v)


@pytest.mark.parametrize("bad", [0.0, -1.0, 0.3, 0.47, math.nan, math.inf,
                                 "0.9"])
def test_invalid_supply_raises_like_reference(bad):
    with pytest.raises(ValueError) as te:
        tenergy.validate_vdd(bad, what="vdd axis point")
    with pytest.raises(ValueError) as je:
        jenergy.validate_vdd(bad, what="vdd axis point")
    assert str(te.value) == str(je.value)
    if isinstance(bad, float) and math.isfinite(bad):
        for fn in ("energy_per_cycle_j", "frequency_mhz"):
            with pytest.raises(ValueError):
                getattr(tenergy, fn)(bad)
    with pytest.raises(KeyError):
        tenergy.variant_tops_per_w(0.9, "no-such-variant")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("vdd", (0.6, 0.9, 1.2))
def test_op_energy_and_reports_equal(variant, vdd):
    for kw in POINTS:
        tspec = TSpec().replace(vdd=vdd, **kw)
        jspec = JSpec().replace(vdd=vdd, **kw)
        assert tenergy.op_energy_j(tspec, variant) == \
            jenergy.op_energy_j(jspec, variant), kw
        assert tvariants.get(variant).hw_cost(tspec) == \
            jvariants.get(variant).hw_cost(jspec), kw
        tcfg, jcfg = TConfig(vdd=vdd, **kw), JConfig(vdd=vdd, **kw)
        assert dataclasses.asdict(tenergy.macro_report(tcfg, variant)) == \
            dataclasses.asdict(jenergy.macro_report(jcfg, variant)), kw
        for m, k, n in ((1, 64, 8), (256, 576, 64), (7, 1000, 33)):
            assert tenergy.layer_energy_j(tcfg, m, k, n, variant) == \
                jenergy.layer_energy_j(jcfg, m, k, n, variant)
