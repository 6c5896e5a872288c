"""repro_torch.distributed.sharding, the axes helpers and ServeEngine(mesh=)
against the JAX reference on the CPU.

The spec functions are pure functions of a mesh's axis names and sizes,
so both packages get the production meshes as names and sizes only: the
reference a duck-typed mesh (as tests/test_sharding.py does), the port
``launch.mesh.make_production_mesh``. The reference builds a
``jax.sharding.NamedSharding`` around every spec, which needs a real mesh
of that many devices; the tests replace its ``NamedSharding`` by a record
of the spec (the reference's rule code runs unchanged) and compare specs
as tuples. Serving with a mesh runs at world size 1 over gloo on the CPU
(``make_host_mesh(device="cpu")``) and must give the reference's tokens
(its engine eager, as tests/test_torch_serve.py runs it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import get_config as jget
from repro.core import engine as jengine
from repro.distributed import sharding as jshd
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro.serve import engine as jserve
from repro.serve import quantized as jquantized
from repro_torch import convert
from repro_torch.configs.base import get_config as tget
from repro_torch.core import engine as tengine
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine as tserve
from repro_torch.serve import quantized as tquantized


class FakeMesh:
    """Duck-typed mesh exposing .shape as a dict (all the rules read)."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {False: FakeMesh(data=16, model=16),
          True: FakeMesh(pod=2, data=16, model=16)}
MESH_IDS = ["single", "multi"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():  # make_host_mesh's single-process group
        dist.destroy_process_group()


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding module with NamedSharding recording the
    spec, so its rules run against a duck-typed production mesh."""
    monkeypatch.setattr(jshd, "NamedSharding",
                        lambda mesh, spec: ("spec", tuple(spec)))
    return jshd


def _port_spec(sh):
    return None if sh is None else ("spec", tuple(sh.spec))


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and dataclass/NamedTuple fields (the
    reference's PlannedWeights and AdamWState included)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}/{k}"))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(
            tree, (type, tshd.NamedSharding)):
        out = {}
        for f in dataclasses.fields(tree):
            if f.name != "weight_bits":  # static in both packages
                out.update(_flat(getattr(tree, f.name), f"{prefix}/{f.name}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# Spec functions
# ---------------------------------------------------------------------------

SPEC_CASES = [
    # the cases of tests/test_sharding.py
    (("embed", "mlp"), (1024, 4096), None),  # TP axes
    (("kv_heads",), (6,), None),  # indivisible -> replicated
    (("batch", "seq"), (256, 4096), None),  # batch over pod and data
    (("a", "b"), (16, 16), {"a": ("model",), "b": ("model",)}),  # no reuse
    ((None, "nope"), (4, 4), None),  # unknown axis
    (("embed", "mlp"), (1024, 4096), "inference"),
    (("experts", "embed", "mlp"), (16, 8192, 24576), "inference"),
    # more divisibility corners
    (("batch",), (1,), None),
    (("batch",), (8,), None),
    (("batch",), (48,), None),
    (("cache_seq", "kv_heads"), (524288, 8), None),
    (("layers", "embed", "heads"), (24, 896, 896), None),
    (("layers", "embed", "heads"), (24, 896, 896), "inference"),
    (("vocab", "embed"), (151936, 896), None),
]


@pytest.mark.parametrize("multi", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("axes,shape,rules", SPEC_CASES)
def test_spec_for_matches_reference(axes, shape, rules, multi):
    jr = jshd.INFERENCE_RULES if rules == "inference" else rules
    tr = tshd.INFERENCE_RULES if rules == "inference" else rules
    want = jshd.spec_for(axes, shape, MESHES[multi], jr)
    got = tshd.spec_for(axes, shape, make_production_mesh(multi_pod=multi),
                        tr)
    assert isinstance(got, tshd.PartitionSpec)
    assert tuple(got) == tuple(want)


KV_SHAPES = [
    (128, 32768, 16, 128),  # gemma3: heads on model
    (128, 32768, 20, 128),  # qwen1.5: the seq fallback
    (1, 524288, 8, 128),  # long_500k: seq absorbs every idle axis
    (40, 128, 32768, 20, 128),  # a leading layers dim
    (24, 128, 32768, 2, 64),  # qwen2-0.5b's stacked cache
    (3, 1, 524288, 8, 128),
]


@pytest.mark.parametrize("multi", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("shape", KV_SHAPES)
def test_kv_cache_spec_matches_reference(shape, multi):
    want = jshd.kv_cache_spec(shape, MESHES[multi])
    got = tshd.kv_cache_spec(shape, make_production_mesh(multi_pod=multi))
    assert tuple(got) == tuple(want)


def test_rule_tables_equal_reference():
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert tshd.INFERENCE_RULES == jshd.INFERENCE_RULES
    assert tshd._ACT_RULES == jshd._ACT_RULES
    assert tshd._CACHE_AXES == jshd._CACHE_AXES
    assert tshd._BATCH_AXES == jshd._BATCH_AXES


# ---------------------------------------------------------------------------
# Every arch: axes, parameter, cache and batch specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_and_planned_axes_match_reference(arch):
    jc, tc = jget(arch), tget(arch)
    want = jt.model_axes(jc)
    got = tt.model_axes(tc)
    assert got == want
    for keep_fp in (False, True):
        assert _flat(tengine.planned_axes(got, keep_fp=keep_fp)) == _flat(
            jengine.planned_axes(want, keep_fp=keep_fp))
    assert _flat(tquantized.quantize_axes_for_serving(got)) == _flat(
        jquantized.quantize_axes_for_serving(want))


@pytest.mark.parametrize("multi", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, multi, ref_specs):
    """Every parameter's spec under DEFAULT_RULES and INFERENCE_RULES, and
    each one divides the mesh."""
    jc, tc = jget(arch), tget(arch)
    shapes = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), jc))
    tparams = tt.abstract_params(tc)
    mesh = make_production_mesh(multi_pod=multi)
    for jr, tr in ((None, None),
                   (jshd.INFERENCE_RULES, tshd.INFERENCE_RULES)):
        want = _flat(ref_specs.tree_shardings(jt.model_axes(jc), shapes,
                                              MESHES[multi], jr))
        got = {k: _port_spec(v) for k, v in _flat(tshd.tree_shardings(
            tt.model_axes(tc), tparams, mesh, tr)).items()}
        assert got == want
    sizes = tshd.axis_sizes(mesh)
    for path, t in _flat(tparams).items():
        sh = _flat(tshd.tree_shardings(tt.model_axes(tc), tparams,
                                       mesh))[path]
        for dim, e in zip(t.shape, sh.spec, strict=False):
            names = () if e is None else e if isinstance(e, tuple) else (e,)
            assert dim % int(np.prod([sizes[n] for n in names])) == 0, path


@pytest.mark.parametrize("multi", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_reference(arch, multi, ref_specs):
    """cache_axes and cache_shardings of the decode_32k and long_500k
    caches, batch_axes and batch shardings of train_4k's batch."""
    jc, tc = jget(arch), tget(arch)
    mesh = make_production_mesh(multi_pod=multi)
    for b, s in ((128, 32768), (1, 524288)):
        jcache = jax.eval_shape(lambda b=b, s=s: jt.init_caches(
            jc, b, s, dtype=jnp.bfloat16))
        tcache = tt.init_caches(tc, b, s, dtype=torch.bfloat16,
                                device="meta")
        assert _flat(tshd.cache_axes(tcache)) == _flat(
            ref_specs.cache_axes(jcache))
        want = _flat(ref_specs.cache_shardings(jcache, MESHES[multi]))
        got = {k: _port_spec(v) for k, v in _flat(
            tshd.cache_shardings(tcache, mesh)).items()}
        assert got == want
    from repro.launch import dryrun as jdry  # noqa: PLC0415 (XLA_FLAGS)
    from repro_torch.launch import dryrun as tdry

    jb = jdry.batch_specs(jc, SHAPES["train_4k"])
    tb = tdry.batch_specs(tc, SHAPES["train_4k"])
    assert tshd.batch_axes(tb) == ref_specs.batch_axes(jb)
    want = _flat(ref_specs.tree_shardings(ref_specs.batch_axes(jb), jb,
                                          MESHES[multi]))
    got = {k: _port_spec(v) for k, v in _flat(tshd.tree_shardings(
        tshd.batch_axes(tb), tb, mesh)).items()}
    assert got == want


def test_opt_state_axes_match_reference():
    jc, tc = jget("granite_moe_1b"), tget("granite_moe_1b")
    want = jshd.opt_state_axes(jt.model_axes(jc), None)
    got = tshd.opt_state_axes(tt.model_axes(tc), None)
    assert isinstance(got, tadamw.AdamWState)
    assert isinstance(want, jadamw.AdamWState)
    assert got.step == want.step == ()
    assert got.m == want.m and got.v == want.v


@pytest.mark.parametrize("multi", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("k,n", [(64, 32), (4096, 32), (64, 24), (100, 48)])
def test_plan_shardings_match_reference(k, n, multi, ref_specs):
    """Every stored-weight field on its N dim, unpacked (K 64, 100) and
    packed (K 4096) planes; N 24 and 48 do not divide 16 and replicate."""
    w = np.random.default_rng(k + n).normal(size=(k, n)).astype(np.float32)
    jplan = jengine.plan_weights(jnp.asarray(w), with_planes=True,
                                 keep_fp=True)
    tplan = tengine.plan_weights(torch.from_numpy(w), with_planes=True,
                                 keep_fp=True)
    assert (tplan.planes.ndim == 3) == (k >= 4096)
    want = ref_specs.plan_shardings(jplan, MESHES[multi])
    got = tshd.plan_shardings(tplan, make_production_mesh(multi_pod=multi))
    for f in ("codes", "scale", "colsum", "w", "planes"):
        assert _port_spec(getattr(got, f)) == getattr(want, f), f


# ---------------------------------------------------------------------------
# Placing planned trees; activation constraints
# ---------------------------------------------------------------------------


def test_shard_planned_on_host_mesh_places_every_tensor():
    """Placements follow planned_param_shardings; each local shard is the
    whole tensor at world size 1; no mesh is a no-op; a mesh of more
    devices raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_host_mesh((1, 1), device="cpu")
    tree = {"blk": {"w": torch.randn(32, 16), "bias": torch.ones(16)}}
    planned = tengine.plan_params(tree, policy=None)
    sh = tshd.planned_param_shardings(planned, mesh)
    assert tuple(sh["blk"]["w"].codes.spec) == (None, "model")
    assert tuple(sh["blk"]["bias"].spec) == ()
    assert sh["blk"]["w"].codes.placements() == (Replicate(), Shard(1))
    assert sh["blk"]["bias"].placements() == (Replicate(), Replicate())
    placed = tshd.shard_planned(planned, mesh)
    for path, t in _flat(placed).items():
        if t is None:
            continue
        assert isinstance(t, DTensor), path
        want = _flat(sh)[path]
        assert t.placements == want.placements(), path
    local = tshd.local_shards(placed)
    for path, t in _flat(planned).items():
        if t is not None:
            assert torch.equal(_flat(local)[path], t), path
    assert tshd.planned_param_shardings(planned, None) is None
    assert tshd.shard_planned(planned, None) is planned
    with pytest.raises(NotImplementedError, match="512 devices"):
        tshd.shard_planned(planned, make_production_mesh(multi_pod=True))
    with pytest.raises(ValueError, match="spans 2 devices"):
        make_host_mesh((2, 1), device="cpu")


def test_constraints_are_identity_and_specs_follow_reference_rules():
    """constrain, constrain_query and the MoE expert-buffer constraint
    return their input with or without an active mesh; their specs follow
    the reference's rules (qwen2-0.5b's 14 heads take the query-seq
    fallback on a 16-wide model axis)."""
    from repro_torch.models import moe as tmoe

    x = torch.randn(4, 8, 16)
    q = torch.randn(2, 32, 14, 64)
    xe = torch.randn(1, 32, 4, 8)
    for ctx in (None, make_host_mesh((1, 1), device="cpu")):
        if ctx is None:
            outs = (tshd.constrain(x, ("act_batch", "act_seq", "act_vocab")),
                    tshd.constrain_query(q), tmoe._constrain_expert_buffer(xe))
        else:
            with tshd.use_mesh(ctx):
                outs = (tshd.constrain(x, ("act_batch", "act_seq",
                                           "act_vocab")),
                        tshd.constrain_query(q),
                        tmoe._constrain_expert_buffer(xe))
        assert outs[0] is x and outs[1] is q and outs[2] is xe
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert tuple(tshd.query_spec((2, 32, 14, 64), m1)) == (
        None, "model", None, None)
    assert tuple(tshd.query_spec((32, 4096, 16, 128), m2)) == (
        ("pod", "data"), None, "model", None)
    assert tuple(tshd.activation_spec(
        (256, 4096, 151936), ("act_batch", "act_seq", "act_vocab"),
        m2)) == (("pod", "data"), None, "model")
    assert tuple(tshd.expert_buffer_spec((1, 32, 4, 8), m1)) == (
        None, "data", None, None)
    with pytest.raises(NotImplementedError, match="256 devices"):
        with tshd.use_mesh(m1):
            pass


def test_forward_under_active_mesh_equals_forward_without():
    """Model code runs its constraints under use_mesh (dense and MoE) and
    gives the same logits bit for bit."""
    mesh = make_host_mesh((1, 1), device="cpu")
    for arch in ("qwen2_0_5b", "granite_moe_1b"):
        cfg = tget(arch, smoke=True)
        params = tt.init(0, cfg, device="cpu")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8))}
        with torch.no_grad():
            want, _ = tt.forward_train(params, batch, cfg)
            with tshd.use_mesh(mesh):
                got, _ = tt.forward_train(params, batch, cfg)
        assert torch.equal(got, want), arch


# ---------------------------------------------------------------------------
# ServeEngine(mesh=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp", "cim-exact"])
def test_sharded_serve_engine_tokens_equal_reference(mode):
    """tests/test_serving.py's sharded case: the planned tree placed on a
    (1, 1) mesh decodes the reference's tokens (its engine with a mesh,
    eager) and the mesh-free engine's; every planned tensor's placement is
    planned_param_shardings'."""
    from repro.configs.base import CIMPolicy as JPolicy
    from repro.core.params import PAPER_OP_16ROWS as JOP
    from repro_torch.configs.base import CIMPolicy as TPolicy
    from repro_torch.core.params import PAPER_OP_16ROWS as TOP

    jc, tc = jget("qwen2_0_5b", smoke=True), tget("qwen2_0_5b", smoke=True)
    if mode != "fp":
        jc = jc.replace(cim=JPolicy(mode=mode, cim=JOP))
        tc = tc.replace(cim=TPolicy(mode=mode, cim=TOP))
    jp = jt.init(jax.random.PRNGKey(0), jc)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 8))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    with jax.disable_jit():
        want = jserve.ServeEngine(jp, jc, max_len=64, batch=2, plan=True,
                                  mesh=jmesh).generate(
            jnp.asarray(prompts, jnp.int32), 6)
    mesh = make_host_mesh((1, 1), device="cpu")
    eng = tserve.ServeEngine(tp, tc, max_len=64, batch=2, plan=True,
                             mesh=mesh, device="cpu")
    got = eng.generate(torch.from_numpy(prompts), 6)
    free = tserve.ServeEngine(tp, tc, max_len=64, batch=2, plan=True,
                              device="cpu").generate(
        torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, free)
    assert eng.mesh is mesh
    want_sh = _flat(tshd.planned_param_shardings(eng.params, mesh))
    placed = {k: v for k, v in _flat(eng.placed).items() if v is not None}
    assert set(placed) == {k for k, v in _flat(eng.params).items()
                           if v is not None}
    for path, t in placed.items():
        assert t.placements == want_sh[path].placements(), path
        assert torch.equal(t.to_local(), _flat(eng.params)[path]), path
