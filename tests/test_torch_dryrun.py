"""repro_torch.launch.dryrun against the JAX reference's dry run, on the CPU.

The port builds each launch cell on ``meta`` tensors (shapes and dtypes,
nothing allocated). For every arch x shape cell, each builder's argument
tree equals the reference's ``ShapeDtypeStruct`` tree leaf by leaf (names
in the reference's flattening order, shapes, dtypes), and its input and
output shardings on both production meshes equal the reference's specs
(the reference's ``NamedSharding`` replaced by a record of the spec, as
tests/test_torch_sharding.py does: a real 256-device mesh is not needed
for the rules). Built at SMOKE size and run on meta, each step's outputs
equal ``jax.eval_shape`` of the reference's step.

FLOPs: the port counts with ``torch.utils.flop_counter.FlopCounterMode``
(matmul-like ops), the reference with XLA's cost analysis, which also
counts elementwise work (norms, activations, softmax, the rotary
embedding, the optimizer's update). So the port's probe counts at most
the reference's and, on the two SMOKE cells held here (prefill, where the
matmuls dominate), at least 0.9 of it (measured: 0.958 dense, 0.948 MoE).
"""

import dataclasses
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jget
from repro.configs.base import shape_cells
from repro.distributed import sharding as jshd
from repro_torch import pytree
from repro_torch.configs.base import CIMPolicy
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import get_config as tget
from repro_torch.core.params import PAPER_OP_16ROWS
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import cim_mac
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

CELLS = [(a, s) for a in ARCH_IDS for s in shape_cells(a)]


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


class Spec:
    """The reference's sharding, as the spec it holds."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if torch.distributed.is_initialized():  # make_host_mesh's group
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jdry():
    """The reference's launch.dryrun, with the XLA_FLAGS its import sets
    (512 host devices) taken out of the environment again."""
    before = os.environ.get("XLA_FLAGS")
    try:
        yield importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _leaves(tree) -> list[tuple[str, tuple, str]]:
    """(name, shape, dtype name) of every leaf of a port tree, in the
    reference's flattening order and names (the checkpoint's)."""
    out = []
    for name, t in pytree.leaves_with_names(tree):
        out.append((name, tuple(t.shape), str(t.dtype).removeprefix(
            "torch.")))
    return out


def _ref_leaves(tree) -> list[tuple[str, tuple, str]]:
    from repro.checkpoint import store as jstore

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jstore._path_name(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat]


def _specs(tree, prefix="") -> dict:
    """{path: spec tuple or None} of a port or reference sharding tree."""
    if isinstance(tree, (tshd.NamedSharding, Spec)):
        return {prefix: tuple(tree.spec)}
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(k, getattr(tree, k)) for k in tree._fields]
    elif isinstance(tree, tuple):
        items = list(enumerate(tree))
    else:
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree) if f.name != "weight_bits"]
    out = {}
    for k, v in items:
        out.update(_specs(v, f"{prefix}/{k}"))
    return out


# ---------------------------------------------------------------------------
# Builders: argument trees and shardings, every cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_builders_match_reference(arch, shape, jdry, monkeypatch):
    """The argument tree (mesh=None, and int8 serving params for a serving
    cell) and, on both production meshes, every input and output spec."""
    monkeypatch.setattr(jshd, "NamedSharding", Spec)
    jc, tc = jget(arch), tget(arch)
    kind = SHAPES[shape].kind
    variants = [False] if kind == "train" else [False, True]
    for quant in variants:
        kw = {"serve_quant": True} if quant else {}
        _, jargs, *_ = jdry._BUILDERS[kind](jc, SHAPES[shape], None, **kw)
        _, targs, tin, tout, tkw = tdry._BUILDERS[kind](
            tc, tdry.SHAPES[shape], None, **kw)
        assert _leaves(targs) == _ref_leaves(jargs), (arch, shape, quant)
        assert all(t.is_meta for t in pytree.leaves(targs))
        assert tin is None or all(v is None for v in _specs(tin).values())
    for multi in (False, True):
        _, _, jin, jout, jkw = jdry._BUILDERS[kind](
            jc, SHAPES[shape], FakeMesh(**make_production_mesh(
                multi_pod=multi).shape))
        _, _, tin, tout, tkw = tdry._BUILDERS[kind](
            tc, tdry.SHAPES[shape], make_production_mesh(multi_pod=multi))
        assert _specs(tin) == _specs(jin), (arch, shape, multi)
        assert _specs(tout) == _specs(jout), (arch, shape, multi)
        assert tkw == jkw


# ---------------------------------------------------------------------------
# Steps run on meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_step_outputs_match_reference_eval_shape(arch, kind, jdry):
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    fn, args, *_ = jdry._BUILDERS[kind](jc, JShape("s", 32, 2, kind), None)
    want = jax.eval_shape(fn, *args)
    tfn, targs, *_ = tdry._BUILDERS[kind](tc, TShape("s", 32, 2, kind), None)
    got = tfn(*targs)
    assert _leaves(got) == _ref_leaves(want)


def test_cim_kernel_meta_steps_launch_nothing():
    """Under cim-kernel every projection reaches B1's meta path: the step
    gives fp's output shapes and nothing is launched or counted."""
    cfg = tget("qwen2_0_5b", smoke=True)
    ker = cfg.replace(cim=CIMPolicy(mode="cim-kernel", cim=PAPER_OP_16ROWS))
    seen = []
    real = cim_mac._abstract_out

    def spy(x, w):
        seen.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    before = dict(cim_mac.LAUNCHES)
    cim_mac._abstract_out = spy
    try:
        for kind in ("prefill", "decode"):
            shape = TShape("s", 16, 2, kind)
            want = tdry._BUILDERS[kind](cfg, shape, None)
            got = tdry._BUILDERS[kind](ker, shape, None)
            assert _leaves(got[0](*got[1])) == _leaves(want[0](*want[1]))
    finally:
        cim_mac._abstract_out = real
    assert dict(cim_mac.LAUNCHES) == before
    # 7 projections per layer, prefill (M = 32) then decode (M = 2)
    per = cfg.n_layers * 7
    assert len(seen) == 2 * per
    assert {m for (m, _), _ in seen[:per]} == {32}
    assert {m for (m, _), _ in seen[per:]} == {2}


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "granite_moe_1b"])
def test_flops_probe_matches_reference(arch, jdry):
    want = jdry.flops_probe(jget(arch, smoke=True),
                            JShape("s", 64, 4, "prefill"), "prefill")
    got = tdry.flops_probe(tget(arch, smoke=True),
                           TShape("s", 64, 4, "prefill"), "prefill")
    assert set(got) == set(want)
    assert got["probe_batch"] == want["probe_batch"]
    for k in ("flops_1unit", "flops_per_unit", "hlo_flops_total"):
        assert 0.9 * want[k] <= got[k] <= want[k], (k, got[k], want[k])


def test_meta_gpq_calls_check_as_a_launch_does():
    """On meta each wrapper makes a launch's checks: the same depth guard
    the plain version raises (DepthGuardError, same message), the spec
    limits and the operand checks; below the guard it returns [M, N]
    float32 on meta, counting nothing."""
    spec = PAPER_OP_16ROWS
    before = dict(cim_mac.LAUNCHES)
    for name, guard_k in (("gpq_matmul", 4096 * 16),
                          ("adder_tree_gpq_matmul", 8192 * 16),
                          ("cell_adc_gpq_matmul", 4096 * 16)):
        fn = getattr(cim_mac, name)
        plain = getattr(cim_mac, f"{name}_plain")
        for k, ok in ((guard_k - 16, True), (guard_k, False)):
            x = torch.empty((3, k), dtype=torch.int32, device="meta")
            w = torch.empty((k, 40), dtype=torch.int8, device="meta")
            if ok:
                y = fn(x, w, spec)
                assert y.is_meta and y.shape == (3, 40)
                assert y.dtype == torch.float32
                continue
            with pytest.raises(cim_mac.DepthGuardError) as got:
                fn(x, w, spec)
            with pytest.raises(cim_mac.DepthGuardError) as want:
                plain(torch.zeros((3, k), dtype=torch.int32),
                      torch.zeros((k, 40), dtype=torch.int8), spec)
            assert str(got.value) == str(want.value)
        x = torch.empty((3, 64), dtype=torch.int32, device="meta")
        w = torch.empty((64, 40), dtype=torch.int8, device="meta")
        with pytest.raises(cim_mac.KernelSpecError):
            fn(x, w, spec.replace(act_bits=9))
        with pytest.raises(TypeError):
            fn(x.float(), w, spec)
        with pytest.raises(ValueError, match="one CUDA device"):
            fn(x, torch.zeros((64, 40), dtype=torch.int8), spec)
    assert dict(cim_mac.LAUNCHES) == before


# ---------------------------------------------------------------------------
# run_cell, the CLI and the sweep measure
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "kind", "cim_mode", "serve_quant",
               "n_params", "n_params_active", "status", "lower_s",
               "compile_s", "memory", "cost", "collectives", "model_flops",
               "wall_s"}


@pytest.mark.parametrize("arch,shape,kw", [
    ("qwen2_0_5b", "decode_32k", {}),
    ("qwen2_0_5b", "decode_32k", {"cim_mode": "cim-kernel"}),
    ("granite_moe_1b", "train_4k", {}),
    ("jamba_1_5_large", "long_500k", {"serve_quant": True}),
    ("whisper_tiny", "prefill_32k", {"kv_cache_dtype": "float8_e4m3fn"}),
])
def test_run_cell_records(arch, shape, kw):
    """The reference's fields; n_params and model_flops are
    validate_cell's; the compile-only fields are null; argument bytes on
    one device are the builder's arguments' bytes under its specs."""
    rec = tdry.run_cell(arch, shape, multi_pod=False, do_probe=False, **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    v = tdry.validate_cell(arch, shape)
    assert {k: rec[k] for k in v} == v
    assert rec["compile_s"] is None and rec["collectives"] is None
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["alias_bytes"] is None
    assert rec["cost"]["bytes_accessed_per_device"] is None
    assert rec["cost"]["flops_per_device"] > 0
    cfg = tget(arch)
    if "cim_mode" in kw:
        cfg = cfg.replace(cim=CIMPolicy(mode=kw["cim_mode"]))
    if "kv_cache_dtype" in kw:
        cfg = cfg.replace(kv_cache_dtype=kw["kv_cache_dtype"])
    assert rec["cim_mode"] == cfg.cim.mode
    kind = tdry.SHAPES[shape].kind
    extra = {"serve_quant": True} if kw.get("serve_quant") else {}
    _, args, in_sh, _, _ = tdry._BUILDERS[kind](
        cfg, tdry.SHAPES[shape], make_production_mesh(), **extra)
    total = sum(t.numel() * t.element_size()
                for t in pytree.leaves(args))
    assert rec["memory"]["argument_bytes"] == tdry.per_device_bytes(
        args, in_sh) < total


def test_per_device_bytes_on_one_device_is_the_total():
    mesh = make_host_mesh((1, 1), device="cpu")
    cfg = tget("qwen2_0_5b")
    _, args, in_sh, _, _ = tdry.build_decode_step(
        cfg, tdry.SHAPES["decode_32k"], mesh)
    total = sum(t.numel() * t.element_size()
                for t in pytree.leaves(args))
    assert tdry.per_device_bytes(args, in_sh) == total
    # params (float32), the token, the position and the bfloat16 cache
    cache = 2 * 24 * 128 * 32768 * 2 * 64 * 2
    tables = 1 if cfg.tie_embeddings else 2  # the padded vocab rows
    n = cfg.param_count() + (cfg.padded_vocab - cfg.vocab_size) * \
        cfg.d_model * tables
    assert total == n * 4 + 128 * 4 + 4 + cache


def test_run_cell_failure_is_recorded(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setitem(tdry._BUILDERS, "decode", broken)
    rec = tdry.run_cell("qwen2_0_5b", "decode_32k", multi_pod=True)
    assert rec["status"] == "fail" and rec["mesh"] == "pod2x16x16"
    assert "no such step" in rec["error"] and "Traceback" in rec["traceback"]
    with pytest.raises(ValueError, match="serving cells"):
        tdry.run_cell("qwen2_0_5b", "train_4k", multi_pod=False,
                      serve_quant=True)


def test_cli_writes_records_and_resumes(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "qwen2_0_5b", "--shape", "decode_32k", "--mesh",
            "both", "--out", str(out)]
    tdry.main(argv)
    recs = json.loads(out.read_text())
    assert set(recs) == {"qwen2_0_5b|decode_32k|single",
                         "qwen2_0_5b|decode_32k|multi"}
    assert all(r["status"] == "ok" for r in recs.values())
    probe = recs["qwen2_0_5b|decode_32k|single"]["flops_probe"]
    assert probe["probe_batch"] == 4 and probe["hlo_flops_total"] > 0
    tdry.main(argv + ["--skip-existing"])
    assert capsys.readouterr().out.count("skip (existing ok)") == 2
    assert tdry.DEFAULT_OUT == tdry.REPO_ROOT / "build" / "dryrun.json"


def test_dryrun_cell_measure_matches_reference_fields():
    from repro.sweep import measures as jmeasures
    from repro_torch.sweep import measures
    from repro_torch.sweep.config import SweepConfig
    from repro_torch.sweep.plan import GridPoint

    m = measures.resolve("dryrun-cell")
    cfg = SweepConfig.from_dict({"name": "d", "measure": "dryrun-cell",
                                 "axes": {"arch": ["qwen2_0_5b"],
                                          "shape": ["decode_32k"]}})
    rec = m.fn(cfg, GridPoint(0, "p0", {"arch": "qwen2_0_5b",
                                        "shape": "decode_32k"}))
    assert rec["status"] == "ok"
    assert set(rec) == RECORD_KEYS - {"wall_s", "lower_s", "compile_s"}
    bad = GridPoint(0, "p0", {"arch": "qwen2_0_5b"})
    assert m.validate(cfg, bad) == jmeasures._dryrun_validate(cfg, bad)
