"""repro_torch's checkpoint write path, restore into a target tree, the
train -> serve handoff and the older int8 leaves, against the JAX
reference on the CPU.

Checkpoints cross both ways bit for bit: the port's ``save`` restores in
the reference's ``store.restore`` and the reference's ``save`` (zlib; the
reference writes zstd where ``zstandard`` is installed, so the tests set
its codec) in the port's. The port's msgpack encoder equals the
``msgpack`` library byte for byte. The reader resolves bfloat16 and
float8_e4m3fn without ``ml_dtypes``, in a fresh interpreter that never
imports JAX. Tokens of a restored planned tree equal the reference's
(its ServeEngine eager, as tests/test_torch_serve.py runs it).
"""

import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs.base import CIMPolicy as JPolicy
from repro.configs.base import get_config as jget
from repro.core import engine as jengine
from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro.serve import engine as jserve
from repro.serve import quantized as jquantized
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.checkpoint import store as tstore
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.configs.base import get_config as tget
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine as tserve
from repro_torch.serve import quantized as tquantized
from repro_torch.train import trainer as ttrainer

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def zlib_reference(monkeypatch):
    """The reference writes zlib, which the port reads."""
    monkeypatch.setattr(jstore, "_DEFAULT_COMPRESSION", "zlib")


def _arrays(rng):
    """One numpy array of each dtype a checkpoint holds (bfloat16 and
    float8 as JAX arrays: numpy needs ml_dtypes for them)."""
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal(5), jnp.bfloat16)),
        "fp8": np.asarray(jnp.asarray(rng.uniform(-400, 400, 6),
                                      jnp.float8_e4m3fn)),
        "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "i8": rng.integers(-128, 128, (4, 2)).astype(np.int8),
        "u32": np.asarray([0, 4294967295], np.uint32),
        "scalar": np.asarray(2.5, np.float32),
    }


def _ref_tree(a):
    """A reference tree with every container kind: dicts, a NamedTuple, a
    dataclass with a None field and a static field, a list, a Python
    scalar."""
    plan = jengine.PlannedWeights(codes=jnp.asarray(a["i8"]),
                                  scale=jnp.asarray(a["f32"][:1, :2]),
                                  colsum=None, weight_bits=8)
    return {
        "w": jnp.asarray(a["f32"]),
        "nested": {"bf": jnp.asarray(a["bf16"]), "f8": jnp.asarray(a["fp8"]),
                   "i": jnp.asarray(a["i32"]), "s": jnp.asarray(a["scalar"])},
        "plan": plan,
        "opt": jadamw.AdamWState(jnp.asarray(3, jnp.int32),
                                 {"x": jnp.asarray(a["f32"])},
                                 {"x": jnp.asarray(a["f32"]) * 2}),
        "rng": jnp.asarray(a["u32"]),
        "lst": [jnp.asarray(a["i8"]), jnp.asarray(a["bf16"])],
        "step": 7,
    }


def _port_tree(a):
    t = convert.to_torch
    plan = tengine.PlannedWeights(codes=t(a["i8"], device="cpu"),
                                  scale=t(a["f32"][:1, :2], device="cpu"),
                                  colsum=None, weight_bits=8)
    return {
        "w": t(a["f32"], device="cpu"),
        "nested": {"bf": t(a["bf16"], device="cpu"),
                   "f8": t(a["fp8"], device="cpu"),
                   "i": t(a["i32"], device="cpu"),
                   "s": t(a["scalar"], device="cpu")},
        "plan": plan,
        "opt": tadamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                                 {"x": t(a["f32"], device="cpu")},
                                 {"x": t(a["f32"], device="cpu") * 2}),
        "rng": t(a["u32"], device="cpu"),
        "lst": [t(a["i8"], device="cpu"), t(a["bf16"], device="cpu")],
        "step": 7,
    }


def _bits(x):
    """The bytes of an array or tensor of any dtype, with its dtype name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.int16 if x.dtype == torch.bfloat16
                       else torch.uint8)
        return name, x.numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.tobytes()


def _assert_same_leaves(port, ref):
    got = tstore.leaves_with_names(port)
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [n for n, _ in got] == [jstore._path_name(p) for p, _ in want]
    for (name, tv), (_, jv) in zip(got, want, strict=True):
        if isinstance(tv, int):  # a Python scalar: the target sets dtypes
            assert np.asarray(jv).item() == tv, name
        else:
            assert _bits(tv) == _bits(jv), name


def test_leaf_names_match_reference():
    a = _arrays(np.random.default_rng(0))
    names = [n for n, _ in tstore.leaves_with_names(_port_tree(a))]
    assert names == jstore._leaf_names(_ref_tree(a))
    assert "plan/codes" in names and "plan/colsum" not in names


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_names_match_reference(compress):
    cfg_j, cfg_t = jget("qwen2_0_5b", smoke=True), tget("qwen2_0_5b",
                                                       smoke=True)
    jp = jt.init(jax.random.PRNGKey(0), cfg_j)
    js = jtrainer.init_train_state(jax.random.PRNGKey(0), jp,
                                   compress=compress)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    ts = ttrainer.init_train_state(ttrainer.make_key(0), tp,
                                   compress=compress)
    payload_t = {"state": ts, "step": 0}
    payload_j = {"state": js, "step": 0}
    got = tstore.leaves_with_names(payload_t)
    want = jax.tree_util.tree_flatten_with_path(payload_j)[0]
    assert [n for n, _ in got] == [jstore._path_name(p) for p, _ in want]
    for (name, tv), (_, jv) in zip(got, want, strict=True):
        assert tuple(getattr(tv, "shape", ())) == np.shape(jv), name
    np.testing.assert_array_equal(ts.rng.numpy(),
                                  np.asarray(jax.random.PRNGKey(0)))


def test_port_save_restores_in_reference(tmp_path):
    a = _arrays(np.random.default_rng(1))
    tstore.save(_port_tree(a), tmp_path, 3)
    assert jstore.latest_step(tmp_path) == 3
    ref = _ref_tree(a)
    target = jax.tree.map(jnp.zeros_like, ref)
    _assert_same_leaves(_port_tree(a), jstore.restore(tmp_path, target))


def test_reference_save_restores_in_port(tmp_path, zlib_reference):
    a = _arrays(np.random.default_rng(2))
    jstore.save(_ref_tree(a), tmp_path, 5)
    target = _port_tree(_arrays(np.random.default_rng(3)))
    out = tstore.restore(tmp_path, target)
    _assert_same_leaves(out, _ref_tree(a))
    assert isinstance(out["plan"], tengine.PlannedWeights)
    assert isinstance(out["opt"], tadamw.AdamWState)
    assert int(out["step"]) == 7
    # without a target: the nested dict of every tensor
    flat = tstore.restore(tmp_path, device="cpu")
    assert sorted(flat) == ["lst", "nested", "opt", "plan", "rng", "step",
                            "w"]
    assert flat["plan"]["codes"].dtype == torch.int8


@pytest.mark.parametrize("obj", [
    {"step": 400, "compression": "zlib", "tensors": [
        {"name": "a/b", "dtype": "bfloat16", "shape": [3, 4], "offset": 0,
         "nbytes": 24}, {"name": "c", "dtype": "int64", "shape": [],
                         "offset": 24, "nbytes": 8}]},
    [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
     2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
     -2**31, -2**31 - 1, -2**63, 1.5, -2.25e300, "", "x" * 31, "y" * 32,
     "z" * 255, "z" * 256, "w" * 70000, "é", b"", b"\x00" * 300,
     b"\x01" * 70000, [], list(range(15)), list(range(16)),
     list(range(70000)), {str(i): i for i in range(15)},
     {str(i): i for i in range(16)}, {str(i): i for i in range(70000)},
     (1, 2)],
])
def test_packb_matches_msgpack(obj):
    want = msgpack.packb(obj)
    assert tstore.packb(obj) == want
    assert tstore.unpackb(want) == msgpack.unpackb(want)


def test_packb_equals_reference_manifest(tmp_path, zlib_reference):
    a = _arrays(np.random.default_rng(4))
    jstore.save(_ref_tree(a), tmp_path / "j", 1)
    tstore.save(_port_tree(a), tmp_path / "t", 1)
    step = "step_00000001/manifest.msgpack"
    manifest = (tmp_path / "j" / step).read_bytes()
    assert tstore.packb(msgpack.unpackb(manifest)) == manifest
    assert (tmp_path / "t" / step).read_bytes() == manifest


def test_roundtrip_latest_and_errors(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32),
                       "c": torch.tensor(2.5, dtype=torch.bfloat16)}}
    tstore.save(tree, tmp_path, 7)
    assert tstore.latest_step(tmp_path) == 7
    assert not list(tmp_path.glob(".tmp_step_*"))
    out = tstore.restore(tmp_path, {"a": torch.zeros(3, 4),
                                    "nested": {"b": torch.zeros(3),
                                               "c": torch.zeros(())}})
    assert torch.equal(out["a"], tree["a"])
    # cast to the target's dtype, as the reference does
    assert out["nested"]["b"].dtype == torch.float32
    assert out["nested"]["c"].item() == 2.5
    with pytest.raises(ValueError, match="shape"):
        tstore.restore(tmp_path, {"a": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="missing"):
        tstore.restore(tmp_path, {"y": torch.zeros(4)})


def test_async_checkpointer_latest_and_error(tmp_path):
    ck = tstore.AsyncCheckpointer()
    for s in [1, 2, 3]:
        ck.save({"x": torch.full((4,), float(s))}, tmp_path, s)
    ck.wait()
    assert tstore.latest_step(tmp_path) == 3
    out = tstore.restore(tmp_path, {"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.full((4,), 3.0))
    (tmp_path / "file").write_text("")
    ck.save({"x": torch.zeros(1)}, tmp_path / "file", 1)  # not a directory
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is raised once


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """A tensor changed in place after ``save`` and before the write ends
    (the next training step) does not reach the checkpoint: the snapshot
    is a copy, also of a tensor that is already on the host."""
    gate = threading.Event()
    real = tstore.save

    def held_save(*args, **kwargs):
        assert gate.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(tstore, "save", held_save)
    x = torch.zeros(4)
    ck = tstore.AsyncCheckpointer()
    ck.save({"x": x, "step": 1}, tmp_path, 1)
    x.add_(5.0)
    gate.set()
    ck.wait()
    out = tstore.restore(tmp_path, {"x": torch.empty(4), "step": 0})
    assert torch.equal(out["x"], torch.zeros(4)) and int(out["step"]) == 1


def test_reader_needs_neither_ml_dtypes_nor_jax(tmp_path, zlib_reference):
    """The fault this reader had: numpy resolves "bfloat16" and
    "float8_e4m3fn" only once ml_dtypes is loaded (JAX loads it), so on a
    host without JAX a checkpoint with such leaves did not restore. A
    fresh interpreter that imports only the port restores the reference's
    checkpoint, and its bytes equal the writer's."""
    a = _arrays(np.random.default_rng(5))
    jstore.save({"bf": jnp.asarray(a["bf16"]), "f8": jnp.asarray(a["fp8"]),
                 "w": jnp.asarray(a["f32"])}, tmp_path, 2)
    code = (
        "import sys\n"
        "from repro_torch.checkpoint import store\n"
        "t = store.restore(sys.argv[1], device='cpu')\n"
        "assert t['bf'].dtype == store.torch.bfloat16, t['bf'].dtype\n"
        "assert t['f8'].dtype == store.torch.float8_e4m3fn, t['f8'].dtype\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "u16, u8 = store.torch.uint16, store.torch.uint8\n"
        "print(t['bf'].view(u16).numpy().tobytes().hex())\n"
        "print(t['f8'].view(u8).numpy().tobytes().hex())\n"
        "print(t['w'].numpy().tobytes().hex())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [a["bf16"].tobytes().hex(),
                                a["fp8"].tobytes().hex(),
                                a["f32"].tobytes().hex()]


# ---------------------------------------------------------------------------
# The older {'w_q', 'w_s'} leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp", "cim-exact"])
def test_legacy_int8_dict_leaves(mode):
    rng = np.random.default_rng(6)
    w_q = rng.integers(-127, 128, (32, 6)).astype(np.int8)
    w_s = rng.uniform(0.001, 0.01, (1, 6)).astype(np.float32)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    jl = {"w": {"w_q": jnp.asarray(w_q), "w_s": jnp.asarray(w_s)}}
    tl = {"w": {"w_q": torch.from_numpy(w_q), "w_s": torch.from_numpy(w_s)}}
    jpol = None if mode == "fp" else JPolicy(mode=mode, cim=JOP)
    tpol = None if mode == "fp" else TPolicy(mode=mode, cim=TOP)
    want = np.asarray(jcommon.linear_apply(jl, jnp.asarray(x), jpol))
    got = tcommon.linear_apply(tl, torch.from_numpy(x), tpol).numpy()
    if mode == "fp":  # one float32 product; the libraries sum apart
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:  # planned per call: bit for bit
        np.testing.assert_array_equal(got, want)
    for dtype, jd in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        deq = tquantized.dequantize_weight(tl["w"], dtype)
        assert torch.equal(deq, tquantized.maybe_dequant(tl["w"], dtype))
        np.testing.assert_array_equal(
            deq.float().numpy(),
            np.asarray(jquantized.dequantize_weight(jl["w"], jd), np.float32))


# ---------------------------------------------------------------------------
# restore_planned
# ---------------------------------------------------------------------------


def _lm_cfgs(mode):
    jc, tc = jget("qwen2_0_5b", smoke=True), tget("qwen2_0_5b", smoke=True)
    return (jc.replace(cim=JPolicy(mode=mode, cim=JOP)),
            tc.replace(cim=TPolicy(mode=mode, cim=TOP)))


@pytest.mark.parametrize("mode", ["cim-exact", "cim"])
def test_restore_planned_reference_checkpoint(tmp_path, zlib_reference, mode):
    """The reference plans and saves; the port restores the planned tree
    into a target built from shapes and serves the reference's tokens
    (batch 2, 8-token prompts, 5 greedy tokens, bfloat16 activations)."""
    jc, tc = _lm_cfgs(mode)
    jp = jt.init(jax.random.PRNGKey(3), jc)
    prompts = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 8))
    with jax.disable_jit():
        planned = jengine.plan_params(jp, policy=jc.cim)
        jstore.save(planned, tmp_path, 11)
        want = jserve.ServeEngine(jp, jc, max_len=16, batch=2, plan=True
                                  ).generate(jnp.asarray(prompts, jnp.int32),
                                             5)
    eng = tserve.ServeEngine.restore_planned(tmp_path, tc, max_len=16,
                                             batch=2, device="cpu")
    wq = eng.params["units"]["layer_00"]["attn"]["wq"]["w"]
    assert isinstance(wq, tengine.PlannedWeights)
    np.testing.assert_array_equal(
        wq.codes.numpy(),
        np.asarray(planned["units"]["layer_00"]["attn"]["wq"]["w"].codes))
    got = eng.generate(torch.from_numpy(prompts).long(), 5)
    np.testing.assert_array_equal(got, want)


def test_abstract_params_match_init():
    cfg = tget("qwen2_0_5b", smoke=True)
    real = tstore.leaves_with_names(tt.init(0, cfg, device="cpu"))
    meta = tstore.leaves_with_names(tt.abstract_params(cfg))
    assert [(n, tuple(t.shape), t.dtype) for n, t in real] == \
        [(n, tuple(t.shape), t.dtype) for n, t in meta]
    assert all(t.is_meta for _, t in meta)


def test_train_to_serve_handoff(tmp_path):
    """Trainer.planned_params -> store.save -> restore_planned serves the
    live plan's tokens."""
    _, tc = _lm_cfgs("cim")
    params = tt.init(0, tc, device="cpu")
    state = ttrainer.init_train_state(ttrainer.make_key(0), params)
    step = ttrainer.make_train_step(
        lambda p, b, g: tt.loss_fn(p, b, tc, generator=g),
        tadamw.OptimizerConfig(lr=1e-3, warmup_steps=1))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tc.vocab_size, (2, 9))).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tr = ttrainer.Trainer(step, state, iter([(0, batch), (1, batch)]),
                          ttrainer.TrainerConfig())
    tr.run(1)
    tstore.save(tr.planned_params(policy=tc.cim), tmp_path, 1)
    eng = tserve.ServeEngine.restore_planned(tmp_path, tc, max_len=16,
                                             batch=2, device="cpu")
    live = tserve.ServeEngine(tr.state.params, tc, max_len=16, batch=2,
                              plan=True, device="cpu")
    np.testing.assert_array_equal(eng.generate(toks[:, :8], 4),
                                  live.generate(toks[:, :8], 4))
