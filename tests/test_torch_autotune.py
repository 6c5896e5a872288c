"""repro_torch's autotune cache and dispatch's "tuned" source, against the
JAX reference's ``kernels.autotune`` on the CPU.

Timing is injected (a fake table per backend), so winners are
deterministic; on the CPU the "cuda" candidates run the kernels' plain
versions. The reference's own round-trip test has no "slots" entry in
its table (ROADMAP C); the tables here cover every backend
``default_candidates`` returns.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.kernels import autotune as jautotune
from repro.kernels import dispatch as jdispatch
from repro_torch.configs.base import CIMPolicy
from repro_torch.core import engine
from repro_torch.core.params import PAPER_OP_16ROWS as OP
from repro_torch.kernels import autotune, cim_mac, dispatch, ops

VARIANTS = ("p8t", "adder-tree", "cell-adc")
SHAPES = ((4, 64, 8), (32, 128, 16))
# Every backend default_candidates returns (the cuda ones at each bn).
TABLES = (
    {"scan": 2.0, "ref": 1.0, "slots": 3.0, 16: 4.0, 32: 5.0, 64: 6.0},
    {"scan": 2.0, "ref": 3.0, "slots": 0.5, 16: 4.0, 32: 5.0, 64: 6.0},
    {"scan": 2.0, "ref": 3.0, "slots": 4.0, 16: 1.5, 32: 0.5, 64: 0.5},
    {"scan": 1.0, "ref": 1.0, "slots": 1.0, 16: 1.0, 32: 1.0, 64: 1.0},
)


@pytest.fixture(autouse=True)
def _heuristics_only():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    autotune.clear_active()
    yield
    autotune.clear_active()
    torch.set_num_threads(n)


def _key(cand):
    backend, block = cand
    return block[1] if backend == "cuda" else backend


def fake_measure(table, outs=None):
    def measure(cand, run):
        out = run()
        if outs is not None:
            outs[cand] = out
        return table[_key(cand)]

    return measure


def _cands():
    return autotune.default_candidates("p8t", include_cuda=True,
                                       device="cpu")


def test_default_candidates_order_and_blocks():
    """dispatch.backends_for order: scan, ref, slots, then the kernel at
    bn 16, 32, 64 as (64, bn, 16 k slots per row group) on a CUDA sweep;
    none of the kernel's on a CPU sweep. 32 rows walk two k16 steps."""
    for v in VARIANTS:
        assert autotune.default_candidates(v, device="cpu") == (
            ("scan", None), ("ref", None), ("slots", None))
        assert autotune.default_candidates(v, include_cuda=True) == (
            ("scan", None), ("ref", None), ("slots", None),
            ("cuda", (64, 16, 16)), ("cuda", (64, 32, 16)),
            ("cuda", (64, 64, 16)))
    assert autotune.default_candidates(
        "p8t", rows=32, include_cuda=True)[-1] == ("cuda", (64, 64, 32))
    assert autotune.default_candidates(
        "p8t", rows=8, include_cuda=True)[-1] == ("cuda", (64, 64, 16))


@pytest.mark.parametrize("table", TABLES, ids=range(len(TABLES)))
def test_tuning_cache_round_trip_determinism(table, tmp_path):
    """The same sweep twice: the same winners (the fastest, the earlier
    one on a tie) and byte-identical saved files; the JSON round-trips;
    every candidate's output equals the scan's."""
    outs = {}
    kw = dict(variants=VARIANTS, candidates=_cands(), activate=False,
              merge=False, device="cpu")
    c1 = autotune.autotune(SHAPES, OP, measure=fake_measure(table, outs),
                           path=tmp_path / "a.json", **kw)
    c2 = autotune.autotune(SHAPES, OP, measure=fake_measure(table),
                           path=tmp_path / "b.json", **kw)
    assert (tmp_path / "a.json").read_bytes() == (
        tmp_path / "b.json").read_bytes()
    assert c1.to_json() == c2.to_json()
    rt = autotune.TuningCache.from_json(json.loads(
        (tmp_path / "a.json").read_text()))
    assert rt.to_json() == c1.to_json() and rt.arch == "cpu"
    best = min(_cands(), key=lambda c: table[_key(c)])  # first on a tie
    assert len(c1.entries) == len(VARIANTS) * len(SHAPES)
    for win in c1.entries.values():
        assert (win.backend, win.block) == best
        assert win.us == table[_key(best)] * 1e6 and win.swept_at == 1
    scan = outs[("scan", None)]
    for cand, out in outs.items():
        assert torch.equal(out, scan), cand


@pytest.mark.parametrize("table", TABLES[:3], ids=range(3))
def test_same_winners_as_reference(table):
    """Under the same injected measure the port pins the reference's
    backend in every (variant, cell); the candidates both sweep on the
    CPU are scan, ref and slots."""
    jcands = jautotune.default_candidates("p8t")
    assert [b for b, _ in jcands] == [b for b, _ in autotune.default_candidates(
        "p8t", device="cpu")]
    for v in VARIANTS:
        for m, k, n in SHAPES:
            want = jautotune.sweep_shape(v, JOP, m, k, n,
                                         measure=fake_measure(table))
            got = autotune.sweep_shape(v, OP, m, k, n, device="cpu",
                                       measure=fake_measure(table))
            assert (got.backend, got.block, got.us) == (
                want.backend, want.block, want.us)
            assert dispatch.shape_cell(m, k, n) == jdispatch.shape_cell(
                m, k, n)


def test_sweep_operands_are_the_reference_served_plan():
    """sweep_shape's operands: the reference's codes from the same numpy
    seed, its packed planes and its spread slots."""
    from repro.core import engine as jengine
    from repro.core import quant as jquant

    m, k, n = 5, 40, 12
    x, w, planes, slots = autotune.sweep_operands(OP, m, k, n, seed=3,
                                                  device="cpu")
    rng = np.random.default_rng(3)
    jx = rng.integers(0, JOP.act_levels, (m, k))
    jw = rng.integers(-128, 128, (k, n)).astype(np.int8)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(w.numpy(), jw)
    w32 = jnp.asarray(jw, jnp.int32)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jengine._grouped_planes(w32, JOP,
                                                           packed=True)))
    np.testing.assert_array_equal(
        slots.numpy(), np.asarray(jquant.spread_slots(w32, 16, 4, 8)))


def test_infeasible_candidates_skipped_and_none_raises():
    def boom(xc, wc, spec, *, generator=None, planes=None):
        raise ValueError("infeasible")

    key = dispatch.register_kernel(dispatch.KernelKey("p8t", "boom"), boom)
    try:
        win = autotune.sweep_shape(
            "p8t", OP, 4, 64, 8, device="cpu",
            candidates=(("boom", None), ("scan", None)),
            measure=fake_measure({"scan": 1.0, "boom": 0.0}))
        assert win.backend == "scan"
        with pytest.raises(RuntimeError, match="no feasible"):
            autotune.sweep_shape("p8t", OP, 4, 64, 8, device="cpu",
                                 candidates=(("boom", None),),
                                 measure=fake_measure({"boom": 0.0}))
    finally:
        dispatch._TABLE.pop(key)


@pytest.mark.parametrize("exc", [RuntimeError, TypeError])
def test_sweep_raises_when_a_kernel_fails(exc, monkeypatch):
    """A kernel that fails to build or launch is not an infeasible
    candidate: the sweep raises instead of pinning another backend."""
    def fail(*a, **kw):
        raise exc("launch failed")

    monkeypatch.setattr(ops, "cim_matmul_kernel", fail)
    with pytest.raises(exc, match="launch failed"):
        autotune.sweep_shape("p8t", OP, 4, 64, 8, device="cpu",
                             candidates=_cands(),
                             measure=fake_measure(TABLES[0]))
    with pytest.raises(exc, match="launch failed"):
        autotune.autotune([(4, 64, 8)], OP, variants=("p8t",),
                          candidates=_cands(), save=False, activate=False,
                          merge=False, device="cpu",
                          measure=fake_measure(TABLES[0]))


def test_merge_sweep_version_and_stale_entries(tmp_path):
    """A merging re-sweep of one shape bumps sweep_version and stamps only
    that cell; the other cell is stale. cache_from_records does the same
    over a previous cache; a Winner round-trips, a legacy one reads
    swept_at 0."""
    path = tmp_path / "cpu.json"
    meas = fake_measure(TABLES[0])
    kw = dict(variants=("p8t",), device="cpu", path=path, activate=False,
              measure=meas)
    c1 = autotune.autotune(SHAPES, OP, **kw)
    assert c1.sweep_version == 1 and autotune.stale_entries(c1) == ()
    c2 = autotune.autotune(SHAPES[:1], OP, **kw)
    assert c2.sweep_version == 2 and len(c2.entries) == 2
    assert autotune.stale_entries(c2) == ("p8t/m32_k128_n16",)
    assert autotune.TuningCache.load(path=path).to_json() == c2.to_json()
    c3 = autotune.autotune(SHAPES[:1], OP, merge=False, **kw)
    assert c3.sweep_version == 1 and len(c3.entries) == 1

    prev = autotune.TuningCache(arch="cpu", sweep_version=2)
    prev.put("p8t", (8, 512, 512), autotune.Winner("ref", None, 1.0, 2))
    prev.put("p8t", (4, 64, 8), autotune.Winner("scan", None, 1.0, 1))
    cache = autotune.cache_from_records("cpu", [
        {"variant": "p8t", "cell": [4, 64, 8], "backend": "cuda",
         "block": [64, 32, 16], "us": 3.0}], prev=prev)
    assert cache.sweep_version == 3
    assert cache.lookup("p8t", (4, 64, 8)) == autotune.Winner(
        "cuda", (64, 32, 16), 3.0, 3)
    assert autotune.stale_entries(cache) == ("p8t/m8_k512_n512",)
    w = autotune.Winner("cuda", (64, 16, 16), 12.5, swept_at=3)
    assert autotune.Winner.from_json(w.to_json()) == w
    assert autotune.Winner.from_json(
        {"backend": "ref", "block": None, "us": 1.0}).swept_at == 0
    # The reference's JSON layout, key for key.
    jprev = jautotune.TuningCache(arch="cpu", sweep_version=2)
    jprev.put("p8t", (8, 512, 512), jautotune.Winner("ref", None, 1.0, 2))
    assert jprev.to_json() == autotune.TuningCache(
        arch="cpu", sweep_version=2, entries={
            "p8t/m8_k512_n512": autotune.Winner("ref", None, 1.0, 2)}
    ).to_json()


def _codes(m, k, n, seed=0):
    x, w, _, _ = autotune.sweep_operands(OP, m, k, n, seed=seed,
                                         device="cpu")
    return x, w


def test_missing_or_corrupt_cache_degrades_to_heuristics(
        tmp_path, monkeypatch, caplog):
    """No <arch>.json: one log line naming it, then the heuristics. An
    unreadable one: one warning, then the heuristics. An explicit load
    keeps its error."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path))
    assert autotune.cache_path("cpu") == tmp_path / "cpu.json"
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.autotune"):
        assert autotune.reload_active() is None
        assert autotune.active_cache() is None  # cached; no second line
        assert autotune.lookup("p8t", (4, 64, 8)) is None
    msgs = [r.getMessage() for r in caplog.records
            if "no tuning cache" in r.getMessage()]
    assert len(msgs) == 1 and str(tmp_path / "cpu.json") in msgs[0]
    x, w = _codes(4, 64, 8)
    with dispatch.record_resolutions() as log:
        y = dispatch.dispatch(x, w, OP)
    assert [r.source for r in log] == ["heuristic"]
    assert torch.equal(y, dispatch.dispatch(x, w, OP, backend="scan"))

    (tmp_path / "cpu.json").write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable tuning cache"):
        assert autotune.reload_active() is None
    with dispatch.record_resolutions() as log:
        dispatch.dispatch(x, w, OP)
    assert [r.source for r in log] == ["heuristic"]
    (tmp_path / "cpu.json").write_text(json.dumps({"version": 99,
                                                   "entries": {}}))
    with pytest.warns(UserWarning, match="version"):
        assert autotune.reload_active() is None
    with pytest.raises(ValueError, match="version"):
        autotune.TuningCache.load(path=tmp_path / "cpu.json")
    # A saved cache at the default path is what dispatch then consults.
    cache = autotune.TuningCache(arch="cpu")
    cache.put("p8t", (4, 64, 8), autotune.Winner("ref", None, 1.0))
    assert cache.save() == tmp_path / "cpu.json"
    assert autotune.reload_active().to_json() == cache.to_json()


@pytest.mark.parametrize("variant", VARIANTS)
def test_tuned_source_and_explicit_backend_wins(variant):
    """An active pin is consulted before the heuristics (source "tuned",
    the pinned block recorded for the kernel), other cells stay heuristic,
    an explicit backend wins over the pin, and every route gives the scan's
    result."""
    x, w = _codes(4, 64, 8)
    want = dispatch.dispatch(x, w, OP, variant=variant, backend="scan")
    cell = dispatch.shape_cell(4, 64, 8)
    cache = autotune.TuningCache(arch="cpu")
    cache.put(variant, cell, autotune.Winner("cuda", (64, 32, 16), 1.0))
    autotune.set_active(cache)
    with dispatch.record_resolutions() as log:
        got = dispatch.dispatch(x, w, OP, variant=variant)
    assert [(r.source, r.key.backend, r.block) for r in log] == [
        ("tuned", "cuda", (64, 32, 16))]
    assert torch.equal(got, want)
    with dispatch.record_resolutions() as log:
        got = dispatch.dispatch(x, w, OP, variant=variant, backend="ref")
    assert [(r.source, r.key.backend) for r in log] == [("explicit", "ref")]
    assert torch.equal(got, want)
    x2, w2 = _codes(64, 256, 64)
    with dispatch.record_resolutions() as log:
        dispatch.dispatch(x2, w2, OP, variant=variant)
    assert [r.source for r in log] == ["heuristic"]
    # An explicit block wins over the pinned one.
    with dispatch.record_resolutions() as log:
        dispatch.dispatch(x, w, OP, variant=variant, block=(64, 16, 16))
    assert log[0].block == (64, 16, 16)


@pytest.mark.parametrize("pin", [("cuda", (64, 128, 16)),
                                 ("cuda", (64, 48)),
                                 ("slots", None),
                                 ("pallas", (128, 128, 128))],
                         ids=["bn128", "short-block", "slots-without-slots",
                              "unregistered"])
def test_stale_pin_falls_back_to_heuristics_recorded(pin):
    """A pin the call cannot take (a bn the kernels are not built for, a
    slots pin on a call without slots, a backend the variant lacks) runs
    nothing: the heuristics pick instead (the scan, on the CPU without
    slots), recorded as "tuned-fallback"."""
    x, w = _codes(3, 32, 4)
    cache = autotune.TuningCache(arch="cpu")
    cache.put("p8t", dispatch.shape_cell(3, 32, 4),
              autotune.Winner(pin[0], pin[1], 1.0))
    autotune.set_active(cache)
    with dispatch.record_resolutions() as log:
        y = dispatch.dispatch(x, w, OP)
    assert [(r.source, r.key.backend) for r in log] == [
        ("tuned-fallback", "scan")]
    assert torch.equal(y, dispatch.dispatch(x, w, OP, backend="scan"))


def test_pin_keeps_only_bn_across_rows():
    """A "cuda" pin fixes only bn: bm and bk follow the call's rows_active,
    so a pin swept at 16 rows (or written with another bm) serves a 32-row
    call at cuda_block(32, bn)."""
    op32 = OP.replace(rows_per_group=32, rows_active=32)
    x, w = _codes(3, 64, 4)
    cache = autotune.TuningCache(arch="cpu")
    cache.put("p8t", dispatch.shape_cell(3, 64, 4),
              autotune.Winner("cuda", (128, 32, 16), 1.0))
    autotune.set_active(cache)
    for spec, block in ((OP, (64, 32, 16)), (op32, (64, 32, 32))):
        with dispatch.record_resolutions() as log:
            y = dispatch.dispatch(x, w, spec)
        assert [(r.source, r.key.backend, r.block) for r in log] == [
            ("tuned", "cuda", block)]
        assert torch.equal(y, dispatch.dispatch(x, w, spec, backend="scan"))
    # An explicit block the kernels do not take raises, pinned or not.
    with pytest.raises(ValueError, match="not the cuda"):
        dispatch.dispatch(x, w, OP, block=(128, 32, 16))
    with pytest.raises(ValueError, match="not the cuda"):
        dispatch.dispatch(x, w, OP, backend="cuda", block=(64, 32, 32))


@pytest.mark.parametrize("exc", [ValueError, RuntimeError, TypeError])
def test_tuned_pin_kernel_errors_propagate(exc, monkeypatch):
    """Under a tuned "cuda" pin an operand fault (the wrappers' ValueError
    or TypeError) or a launch failure (RuntimeError) raises: only the
    depth guard and the spec check fall back to the scan."""
    x, w = _codes(3, 32, 4)
    cache = autotune.TuningCache(arch="cpu")
    cache.put("p8t", dispatch.shape_cell(3, 32, 4),
              autotune.Winner("cuda", (64, 16, 16), 1.0))
    autotune.set_active(cache)

    def fault(*a, **kw):
        raise exc("operand fault")

    monkeypatch.setattr(ops, "cim_matmul_kernel", fault)
    with pytest.raises(exc, match="operand fault"):
        dispatch.dispatch(x, w, OP)
    for guard, source in ((cim_mac.DepthGuardError, "guard-fallback"),
                          (cim_mac.KernelSpecError, "spec-fallback")):
        def infeasible(*a, _g=guard, **kw):
            raise _g("infeasible")

        monkeypatch.setattr(ops, "cim_matmul_kernel", infeasible)
        with dispatch.record_resolutions() as log:
            y = dispatch.dispatch(x, w, OP)
        assert [(r.source, r.key.backend) for r in log] == [
            ("tuned", "cuda"), (source, "scan")]
        assert torch.equal(y, dispatch.dispatch(x, w, OP, backend="scan"))


@pytest.mark.parametrize("name", ["gpq_matmul", "adder_tree_gpq_matmul",
                                  "cell_adc_gpq_matmul"])
def test_wrappers_validate_bn(name):
    """bn None or 0 keeps the choice by N; 16, 32 and 64 give the plain
    version's result; anything else raises on either device."""
    x, w = _codes(5, 48, 20, seed=1)
    fn = getattr(cim_mac, name)
    want = getattr(cim_mac, f"{name}_plain")(x, w, OP)
    for bn in (None, 0, 16, 32, 64):
        assert torch.equal(fn(x, w, OP, bn=bn), want)
    for bn in (8, 48, 128, -16, 1):
        with pytest.raises(ValueError, match="column tile"):
            fn(x, w, OP, bn=bn)
    assert cim_mac.check_bn(None) == 0 and cim_mac.check_bn(32) == 32


def test_register_tuned_backend_pins_block_through_dispatch():
    """ops.register_tuned_backend: an engine backend whose every matmul is
    an explicit ("p8t", "cuda") dispatch at the pinned block, equal to the
    cim-kernel mode's output; a bn the kernel does not take raises."""
    rng = np.random.default_rng(5)
    wf = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32))
    xf = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    name = ops.register_tuned_backend(bn=64)
    try:
        pol = CIMPolicy(mode="cim-kernel", cim=OP)
        plan = engine.plan_weights(wf, pol.cim, pol)
        want = engine.execute(xf, plan, pol)
        with dispatch.record_resolutions() as log:
            got = engine.execute(xf, plan, CIMPolicy(mode="cim-kernel", cim=OP,
                                                     backend=name))
        assert [(r.source, r.key.backend, r.block) for r in log] == [
            ("explicit", "cuda", (64, 64, 16))]
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="bn"):
            ops.register_tuned_backend(bn=0)
    finally:
        engine._BACKENDS.pop(name)


def test_sweeps_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without ``device=`` a sweep and its candidates are the card's; only
    ``device="cpu"`` sweeps on the CPU (here, without a card, the card's
    sweep fails where its operands are made)."""
    seen = []
    real = autotune.sweep_operands

    def operands(spec, m, k, n, *, seed=0, device="cpu"):
        seen.append(torch.device(device).type)
        if torch.device(device).type == "cuda":
            raise RuntimeError("no card here")
        return real(spec, m, k, n, seed=seed, device=device)

    monkeypatch.setattr(autotune, "sweep_operands", operands)
    assert ("cuda", dispatch.cuda_block(16, 16)) in \
        autotune.default_candidates("p8t")
    with pytest.raises(RuntimeError, match="no card"):
        autotune.sweep_shape("p8t", OP, 4, 64, 8,
                             measure=fake_measure(TABLES[0]))
    with pytest.raises(RuntimeError, match="no card"):
        autotune.autotune([(4, 64, 8)], OP, variants=("p8t",), arch="sm90",
                          save=False, activate=False, merge=False,
                          measure=fake_measure(TABLES[0]))
    assert seen == ["cuda", "cuda"]
    win = autotune.sweep_shape("p8t", OP, 4, 64, 8, device="cpu",
                               measure=fake_measure(TABLES[0]))
    assert win.backend == "ref" and seen[-1] == "cpu"
