"""repro_torch's LM stack (configs, layers, planning, attention, the
transformer's prefill/decode) against the JAX reference on the CPU.

The reference's parameters come from its own ``transformer.init`` and are
carried across with ``convert.to_torch``. Bit-exact checks run the
reference eagerly (``jax.disable_jit``: XLA fuses and refolds float ops
inside jit, and with bfloat16 keeps excess float32 precision between
fused ops, which moves activation codes); the port follows the eager
per-op rounding. Tolerances are stated per test: float32 layers 1e-5 to
1e-6, bfloat16 ones one bfloat16 step (2**-7 relative), logits of the
digital path per dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.base import CIMPolicy as JPolicy
from repro.core import engine as jengine
from repro.core import quant as jquant
from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.data.synthetic import MarkovLM as JMarkov
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import engine as tengine
from repro_torch.core import quant as tquant
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.data.synthetic import MarkovLM as TMarkov
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt

DENSE = ("qwen2_0_5b", "qwen1_5_4b", "yi_34b", "gemma3_27b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    """qwen2 SMOKE: the reference's params and the same carried across."""
    cfg = jbase.get_config("qwen2_0_5b", smoke=True)
    jp = jt.init(jax.random.PRNGKey(0), cfg)
    return {"jparams": jp,
            "tparams": convert.to_torch(jax.tree.map(np.asarray, jp),
                                        device="cpu")}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.is_floating_point() \
            else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name in ("bfloat16", "float8_e4m3fn") else a


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _cfgs(mode, act="float32", **kw):
    jc = jbase.get_config("qwen2_0_5b", smoke=True)
    tc = tbase.get_config("qwen2_0_5b", smoke=True)
    if mode != "fp":
        jc = jc.replace(cim=JPolicy(mode="cim" if mode == "cim-kernel"
                                    else mode, cim=JOP))
        tc = tc.replace(cim=TPolicy(mode=mode, cim=TOP))
    return (jc.replace(activation_dtype=act, **kw),
            tc.replace(activation_dtype=act, **kw))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


NEUTRAL_MULTIPLIERS = dict(embedding_multiplier=1.0, attention_multiplier=0.0,
                           residual_multiplier=1.0, logits_scaling=1.0)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["cim"] = dataclasses.asdict(cfg.cim)
    return d


def _port_fields(cfg):
    """A port config's fields less its four Granite multipliers, which
    the JAX package lacks: they must sit at their neutral values."""
    d = _fields(cfg)
    assert {k: d.pop(k) for k in NEUTRAL_MULTIPLIERS} == NEUTRAL_MULTIPLIERS
    assert cfg.attn_scale == cfg.head_dim ** -0.5
    return d


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_reference(arch, smoke):
    j = jbase.get_config(arch, smoke=smoke)
    t = tbase.get_config(arch, smoke=smoke)
    assert _port_fields(t) == _fields(j)
    for prop in ("padded_vocab", "q_dim", "kv_dim", "pattern_len"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for i in range(j.n_layers):
        assert t.layer_kind(i) == j.layer_kind(i)
        assert t.layer_uses_moe(i) == j.layer_uses_moe(i)
    r = t.replace(n_layers=3)
    assert isinstance(r, tbase.ModelConfig) and r.n_layers == 3
    assert tt._unit_split(t) == jt._unit_split(j)


def test_registry_records_equal_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.FULL_ATTENTION_ARCHS == jbase.FULL_ATTENTION_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for arch in jbase.ARCH_IDS:
        assert tbase.shape_cells(arch) == jbase.shape_cells(arch)
    for rec in ("MoEConfig", "MambaConfig", "RWKVConfig"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jbase, rec))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tbase, rec))]
        assert tf == jf, rec
    # The qwen2 CONFIG is the published one (arXiv:2407.10671).
    q = tbase.get_config("qwen2_0_5b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.head_dim,
            q.d_ff, q.vocab_size, q.padded_vocab) == (
        24, 896, 14, 2, 64, 4864, 151936, 152064)


@pytest.mark.parametrize("arch", sorted(set(jbase.ARCH_IDS) - set(DENSE)))
def test_unported_archs_raise_naming_their_slice(arch):
    """Every arch of the registry is ported now: the encoder-decoder, the
    VLM stub and the MoE, RWKV-6 and jamba archs load, CONFIG and SMOKE,
    equal field for field to the reference's (parameter counts, the layer
    pattern and the MoE layers too); an unknown arch still raises."""
    for smoke in (False, True):
        j = jbase.get_config(arch, smoke=smoke)
        t = tbase.get_config(arch, smoke=smoke)
        assert _port_fields(t) == _fields(j)
        assert t.padded_vocab == j.padded_vocab
        assert t.pattern_len == j.pattern_len
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        for i in range(j.n_layers):
            assert t.layer_kind(i) == j.layer_kind(i)
            assert t.layer_uses_moe(i) == j.layer_uses_moe(i)
        assert tt._unit_split(t) == jt._unit_split(j)
    with pytest.raises(KeyError):
        tbase.get_config("no_such_arch")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

# One bfloat16 step relative (the outputs round once in bfloat16), float32
# to the last bits of a reduction.
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_norms_rope_and_mlp_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tol = dict(rtol=RTOL[dtype], atol=RTOL[dtype])
    got = tcommon.rmsnorm_apply({"scale": torch.from_numpy(scale)}, tx, 1e-6)
    want = jcommon.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx, 1e-6)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    got = tcommon.layernorm_apply({"scale": torch.from_numpy(scale),
                                   "bias": torch.from_numpy(bias)}, tx, 1e-5)
    want = jcommon.layernorm_apply({"scale": jnp.asarray(scale),
                                    "bias": jnp.asarray(bias)}, jx, 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # RoPE at large positions and theta 1e6 (qwen2), [B, S, H, hd].
    q = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 700, 4095], [7, 8, 9, 10, 11]], np.int32)
    jq_, tq_ = _pair(q, dtype)
    got = tcommon.apply_rope(tq_, torch.from_numpy(pos), 1e6)
    want = jcommon.apply_rope(jq_, jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(
        tcommon.rope_freqs(32, 1e6).numpy(),
        np.asarray(jcommon.rope_freqs(32, 1e6)), rtol=1e-6)
    # SwiGLU and the gelu MLP, digital.
    for act in ("silu", "gelu"):
        spec = jcommon.mlp_spec(64, 96, act)
        jp = jcommon.init_params(jax.random.PRNGKey(1), spec)
        tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
        got = tcommon.mlp_apply(tp, tx, act, None)
        want = jcommon.mlp_apply(jp, jx, act, None)
        # Two chained matmuls of 64 and 96 terms: two bfloat16 steps.
        t2 = 2 * RTOL[dtype] if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(_np(got), _np(want), rtol=t2, atol=t2)
    # gelu alone, bit for bit in bfloat16 over every finite input below 64
    # in magnitude (subnormals included: XLA flushes them), and to one
    # float32 ulp of tanh in float32.
    if dtype == "bfloat16":
        u = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16)
        u = u[torch.isfinite(u) & (u.abs() < 64)]
        assert u.numel() == 34048
        ju = jnp.asarray(u.view(torch.int16).numpy()).view(jnp.bfloat16)
    else:
        u = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                             * 8)
        ju = jnp.asarray(u.numpy())
    got = tcommon._gelu_tanh(u)
    want = jax.nn.gelu(ju)
    assert got.dtype == u.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_cores_match_reference(dtype):
    rng = np.random.default_rng(1)
    b, s, h, kvh, hd = 2, 40, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    (jq_, tq_), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    tol = dict(rtol=RTOL[dtype], atol=RTOL[dtype] if dtype == "bfloat16"
               else 1e-6)
    for window in (0, 7):
        for off in (0, 3):
            np.testing.assert_array_equal(
                tattn.causal_mask(s, s + off, offset=off,
                                  window=window).numpy(),
                np.asarray(jattn.causal_mask(s, s + off, offset=off,
                                             window=window)))
        jm = jattn.causal_mask(s, s, window=window)[None, None, None]
        tm = tattn.causal_mask(s, s, window=window)[None, None, None]
        want = jattn._gqa_core(jq_, jk, jv, jm)
        got = tattn._gqa_core(tq_, tk, tv, tm)
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        # The flash core at a block that does not divide S.
        pos = np.arange(s, dtype=np.int32)
        fw = jattn._flash_core(jq_, jk, jv, q_positions=jnp.asarray(pos),
                               window=window, block=16)
        fg = tattn._flash_core(tq_, tk, tv, q_positions=torch.from_numpy(pos),
                               window=window, block=16)
        np.testing.assert_allclose(_np(fg), _np(fw), **tol)
        np.testing.assert_allclose(_np(fg), _np(got), **tol)
    np.testing.assert_allclose(
        _np(tattn._gqa_core(tq_, tk, tv, None)),
        _np(jattn._gqa_core(jq_, jk, jv, None)), **tol)


# ---------------------------------------------------------------------------
# Planning, the quantizer and execute (bfloat16 too)
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("mode", ["fp", "cim-exact", "cim", "cim-kernel"])
def test_plan_params_matches_reference_on_lm_tree(qwen, mode):
    """Which leaves are planned (stacked units included), and their codes,
    scales, colsums, kept weights, planes and slots, bit for bit; the
    reference plans op by op, outside jit. A 2-D extra leaf checks planes
    and slots, and an exempt module's leaf stays a tensor."""
    jpol = None if mode == "fp" else JPolicy(mode=mode, cim=JOP)
    tpol = None if mode == "fp" else TPolicy(mode=mode, cim=TOP)
    rng = np.random.default_rng(2)
    extra = (rng.standard_normal((100, 24)) / 10).astype(np.float32)
    jtree = dict(qwen["jparams"], head={"w": jnp.asarray(extra)},
                 router={"w": jnp.asarray(extra)})
    ttree = dict(qwen["tparams"], head={"w": torch.from_numpy(extra)},
                 router={"w": torch.from_numpy(extra)})
    jplan = jengine.plan_params(jtree, policy=jpol)
    tplan = tengine.plan_params(ttree, policy=tpol)
    jl = dict(_leaves(jplan))
    tl = dict(_leaves(tplan))
    assert jl.keys() == tl.keys()
    planned = []
    for path, jv in jl.items():
        tv = tl[path]
        if not isinstance(jv, jengine.PlannedWeights):
            assert not isinstance(tv, tengine.PlannedWeights), path
            np.testing.assert_array_equal(_np(tv), _np(jv))
            continue
        planned.append(path)
        assert isinstance(tv, tengine.PlannedWeights), path
        assert tv.weight_bits == jv.weight_bits
        for f in ("codes", "scale", "colsum", "w", "planes", "slots"):
            a, b = getattr(jv, f), getattr(tv, f)
            assert (a is None) == (b is None), (path, f)
            if a is not None:
                assert tuple(b.shape) == tuple(a.shape), (path, f)
                np.testing.assert_array_equal(_np(b), _np(a),
                                              err_msg=f"{path} {f}")
    # 7 stacked projections x 2 weights-or-not, plus the extra head; the
    # router module and every bias, norm and embedding table stay.
    assert sorted(p for p in planned if p[0] == "units") == sorted(
        ("units", "layer_00", m, n, "w") for m, n in
        [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
         ("mlp", "gate"), ("mlp", "up"), ("mlp", "down")])
    assert ("head", "w") in planned and ("router", "w") not in planned
    assert tplan["units"]["layer_00"]["attn"]["wq"]["w"].codes.shape == (
        2, 128, 256)


def test_stacked_plan_layer_view_and_with_planes_guard(qwen):
    pol = TPolicy(mode="cim", cim=TOP)
    w = qwen["tparams"]["units"]["layer_00"]["mlp"]["down"]["w"]
    stacked = tengine.plan_weights(w, policy=pol, with_planes=False)
    for u in range(w.shape[0]):
        one = tengine.plan_weights(w[u], policy=pol, with_planes=False)
        view = stacked.layer(u)
        for f in ("codes", "scale", "colsum", "w"):
            assert torch.equal(getattr(view, f), getattr(one, f)), f
        assert view.codes.data_ptr() == stacked.codes[u].data_ptr()
    with pytest.raises(ValueError, match="2-D"):
        tengine.plan_weights(w, policy=pol)  # planes of a stacked weight
    with pytest.raises(ValueError, match="not stacked"):
        tengine.plan_weights(w[0], policy=pol).layer(0)


@pytest.mark.parametrize("group_rows", [4, 8])
def test_plan_weights_group_rows_bit_exact(group_rows):
    """Planes and slots grouped at a calibrated layer's rows_active (what
    plan_params(calibration=) asks for), bit for bit."""
    w = (np.random.default_rng(7).standard_normal((100, 24)) / 10).astype(
        np.float32)
    jplan = jengine.plan_weights(jnp.asarray(w), policy=JPolicy(mode="cim"),
                                 group_rows=group_rows)
    tplan = tengine.plan_weights(torch.from_numpy(w),
                                 policy=TPolicy(mode="cim"),
                                 group_rows=group_rows)
    for f in ("planes", "slots"):
        a, b = getattr(jplan, f), getattr(tplan, f)
        assert b.shape[-2] == group_rows or f == "planes"
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=f)


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("clip_pct", [1.0, 0.995])
@pytest.mark.parametrize("symmetric", [False, True])
def test_quantize_acts_bfloat16_bit_exact(symmetric, clip_pct, per_token):
    """The quantizer runs in the input's dtype in both packages: scale,
    x / scale and the rounding are bfloat16 on the LM path."""
    for seed, shape in enumerate([(4, 896), (37, 53)]):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(shape) * rng.uniform(0.01, 30)).astype(
            np.float32)
        if symmetric:
            x = np.abs(x)
        jx, tx = _pair(x, "bfloat16")
        for bits in (4, 8):
            jq_ = jquant.quantize_acts(jx, bits, symmetric=symmetric,
                                       per_token=per_token,
                                       clip_pct=clip_pct)
            tq_ = tquant.quantize_acts(tx, bits, symmetric=symmetric,
                                       per_token=per_token,
                                       clip_pct=clip_pct)
            assert tq_.scale.dtype == torch.bfloat16
            for jv, tv in zip(jq_, tq_, strict=True):
                np.testing.assert_array_equal(_np(tv), _np(jv))


@pytest.mark.parametrize("mode", ["cim-exact", "cim", "cim-kernel"])
def test_execute_bfloat16_bit_exact(mode):
    """bfloat16 activations through the quantized backends: the bfloat16
    quantizer, the integer macro and the float32 epilogue with a bfloat16
    activation scale, cast back to bfloat16, bit for bit (the reference
    op by op outside jit; its integer group loop is compiled, and exact)."""
    jpol = JPolicy(mode="cim" if mode == "cim-kernel" else mode, cim=JOP)
    tpol = TPolicy(mode=mode, cim=TOP)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((320, 40)) / 30).astype(np.float32)
    jplan = jengine.plan_weights(jnp.asarray(w), jpol.cim, jpol)
    tplan = tengine.plan_weights(torch.from_numpy(w), tpol.cim, tpol)
    for m in (1, 4, 33):
        x = (rng.standard_normal((m, 320)) * 2).astype(np.float32)
        jx, tx = _pair(x, "bfloat16")
        want = jengine.execute(jx, jplan, jpol)
        got = tengine.execute(tx, tplan, tpol)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))


def test_execute_fp_bfloat16_close():
    """The digital int8 serving plan in bfloat16: one bfloat16 matmul of
    896 terms, summed in another order: two bfloat16 steps."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((896, 40)) / 30).astype(np.float32)
    x = rng.standard_normal((4, 896)).astype(np.float32)
    jx, tx = _pair(x, "bfloat16")
    jplan = jengine.plan_weights(jnp.asarray(w), keep_fp=False)
    tplan = tengine.plan_weights(torch.from_numpy(w), keep_fp=False)
    want = jengine.execute(jx, jplan, JPolicy())
    got = tengine.execute(tx, tplan, TPolicy())
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -6,
                               atol=2 ** -6)


# ---------------------------------------------------------------------------
# The transformer: prefill + decode against the reference
# ---------------------------------------------------------------------------

S, B, MAX = 8, 2, 16


def _record(monkeypatch, module, calls):
    real = module.execute

    def rec(x, plan, policy, **kw):
        y = real(x, plan, policy, **kw)
        calls.append((x, plan, y))
        return y

    monkeypatch.setattr(module, "execute", rec)
    return real


def _serve_ref(jparams, jc, toks, steps, act, eager=True):
    """The reference's prefill + greedy decode: eagerly for bit-exact
    checks, else jitted (one compile per step kind)."""
    jcache = jt.init_caches(jc, B, MAX, dtype=jnp.dtype(act))
    pre, dec = jt.prefill, jt.decode_step
    if not eager:
        pre = jax.jit(pre, static_argnums=(3,))
        dec = jax.jit(dec, static_argnums=(4,))
    with jax.disable_jit(eager):
        lg, jcache = pre(jparams, jnp.asarray(toks), jcache, jc)
        out = [lg]
        for i in range(steps):
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            lg, jcache = dec(jparams, tok, jnp.asarray(S + i, jnp.int32),
                             jcache, jc)
            out.append(lg)
    return [_np(o) for o in out], jcache


def _serve_port(tparams, tc, toks, steps, act):
    tcache = tt.init_caches(tc, B, MAX, dtype=getattr(torch, act),
                            device="cpu")
    with torch.no_grad():
        lg, tcache = tt.prefill(tparams, torch.from_numpy(toks).long(),
                                tcache, tc)
        out = [lg]
        for i in range(steps):
            lg, tcache = tt.decode_step(tparams, torch.argmax(lg, -1),
                                        S + i, tcache, tc)
            out.append(lg)
    return [_np(o) for o in out], tcache


@pytest.mark.parametrize("mode", ["fp", "cim-exact", "cim", "cim-kernel"])
def test_prefill_decode_matches_reference(qwen, mode, monkeypatch):
    """qwen2 SMOKE, prefill of 8 tokens then 3 greedy decode steps.

    fp: bfloat16 activations (the config's), logits within 3e-2 (a few
    bfloat16 steps of O(1) logits) and the same greedy tokens. CIM modes:
    float32 activations, the weights planned (the reference's eager
    plan); every projection's macro output is bit-exact when the port
    executes the reference's own input (identical codes), and the greedy
    tokens are equal. The port's cim-kernel (on the CPU: B1's plain
    version) is held to the reference's cim."""
    act = "bfloat16" if mode == "fp" else "float32"
    jc, tc = _cfgs(mode, act)
    toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    jparams, tparams = qwen["jparams"], qwen["tparams"]
    if mode != "fp":
        with jax.disable_jit():
            jparams = jengine.plan_params(jparams, policy=jc.cim)
        tparams = convert.to_torch(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    jcalls, tcalls = [], []
    _record(monkeypatch, jengine, jcalls)
    execute = _record(monkeypatch, tengine, tcalls)
    want, _ = _serve_ref(jparams, jc, toks, 3, act, eager=mode != "fp")
    got, _ = _serve_port(tparams, tc, toks, 3, act)
    for w_, g_ in zip(want, got, strict=True):
        np.testing.assert_array_equal(g_.argmax(-1), w_.argmax(-1))
        if mode == "fp":
            np.testing.assert_allclose(g_, w_, atol=3e-2, rtol=3e-2)
    if mode == "fp":
        assert not jcalls and not tcalls
        return
    # 7 projections x 2 layers x (prefill + 3 decode steps).
    assert len(jcalls) == len(tcalls) == 7 * 2 * 4
    for (jx, _, jy), (_, tplan, _) in zip(jcalls, tcalls, strict=True):
        y = execute(torch.from_numpy(np.array(jx)), tplan, tc.cim)
        np.testing.assert_array_equal(_np(y), _np(jy))


def test_forward_train_matches_reference_and_prefill(qwen):
    """forward_train (forward only) against the reference's, float32,
    and the port's prefill logits equal its forward's last position."""
    jc, tc = _cfgs("fp", "float32")
    toks = np.random.default_rng(5).integers(0, 512, (B, S)).astype(np.int32)
    want, aux = jt.forward_train(qwen["jparams"],
                                 {"tokens": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        got, taux = tt.forward_train(
            qwen["tparams"], {"tokens": torch.from_numpy(toks).long()}, tc)
        last, _ = tt.prefill(qwen["tparams"], torch.from_numpy(toks).long(),
                             tt.init_caches(tc, B, MAX, dtype=torch.float32,
                                            device="cpu"), tc)
    assert got.shape == (B, S, tc.padded_vocab) and float(taux) == float(aux)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(last.numpy(), got[:, -1].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_ring_cache_window_semantics_gemma3():
    """The reference's ring-cache case on gemma3 SMOKE (window 8, 20
    tokens, 4 prefilled then decoded past two wraps): the port's decode
    logits equal its full forward's within 1e-3, and the reference's
    (carried-across params) within 1e-3, and so do the ring caches (float32
    projections eight layers deep, summed in another order)."""
    jc = jbase.get_config("gemma3_27b", smoke=True).replace(
        activation_dtype="float32", window_size=8)
    tc = tbase.get_config("gemma3_27b", smoke=True).replace(
        activation_dtype="float32", window_size=8)
    b, s = 1, 20
    key = jax.random.PRNGKey(3)
    jp = jt.init(key, jc)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.asarray(jax.random.randint(key, (b, s), 0, jc.vocab_size))
    ttoks = torch.from_numpy(toks).long()
    jcache = jt.init_caches(jc, b, s, dtype=jnp.float32)
    jdec = jax.jit(jt.decode_step, static_argnums=(4,))
    _, jcache = jax.jit(jt.prefill, static_argnums=(3,))(
        jp, jnp.asarray(toks[:, :4]), jcache, jc)
    for t in range(4, s):
        jlg, jcache = jdec(jp, jnp.asarray(toks[:, t]),
                           jnp.asarray(t, jnp.int32), jcache, jc)
    with torch.no_grad():
        full, _ = tt.forward_train(tp, {"tokens": ttoks}, tc)
        tcache = tt.init_caches(tc, b, s, dtype=torch.float32, device="cpu")
        assert tcache["units"]["layer_00"].k.shape == (1, b, 8, 2, 32)
        assert tcache["units"]["layer_05"].k.shape == (1, b, s, 2, 32)
        _, tcache = tt.prefill(tp, ttoks[:, :4], tcache, tc)
        for t in range(4, s):
            lg, tcache = tt.decode_step(tp, ttoks[:, t], t, tcache, tc)
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(lg.numpy(), _np(jlg), atol=1e-3, rtol=1e-3)
    for path, tv in _leaves({k: dict(zip("kv", v)) if isinstance(v, tuple)
                             else {j: dict(zip("kv", c)) for j, c in
                                   v.items()} for k, v in tcache.items()}):
        jv = jcache[path[0]]
        jv = getattr(jv[path[1]], path[2]) if len(path) == 3 else \
            getattr(jv, path[1])
        np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-3,
                                   rtol=1e-3, err_msg=str(path))


def test_fp8_kv_cache_contents():
    """kv_cache_dtype float8_e4m3fn: the cache conversion is bit for bit
    the reference's ``astype`` on the same float32 values, out of range
    too (|x| in (448, 1e4], +-inf and NaN of both signs, which the
    reference turns into NaN where torch's own conversion saturates), and
    on every bfloat16 bit pattern; end to end (qwen2 SMOKE, float32
    activations, 15 prefilled tokens) the caches are fp8 and every entry
    is within one e4m3 step (2**-3 relative) of the reference's, where
    the float32 projections summed in another order."""
    rng = np.random.default_rng(6)
    wide = rng.uniform(448.0, 1e4, 2048)
    x = np.concatenate([rng.standard_normal(4096) * 4, wide, -wide,
                        np.array([0.0, 448.0, -448.0, 1 / 1024, 0.3125,
                                  1.0625, 17.0, 463.99997, 464.0, -464.0,
                                  464.00003, -464.00003, 1e4, -1e4, np.inf,
                                  -np.inf, np.nan, -np.nan])
                        ]).astype(np.float32)
    bf16 = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    for tx, jx in ((torch.from_numpy(x), jnp.asarray(x)),
                   (bf16, jnp.asarray(bf16.view(torch.int16).numpy()).view(
                       jnp.bfloat16))):
        got = tattn.to_cache_dtype(tx, torch.float8_e4m3fn)
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy(),
            np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8))
    jc, tc = _cfgs("fp", "float32", kv_cache_dtype="float8_e4m3fn")
    jp = jt.init(jax.random.PRNGKey(3), jc)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (2, 15), 0,
                                         jc.vocab_size))
    jcache = jt.init_caches(jc, 2, 16, dtype=jnp.float32)
    _, jcache = jt.prefill(jp, jnp.asarray(toks), jcache, jc)
    tcache = tt.init_caches(tc, 2, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        _, tcache = tt.prefill(tp, torch.from_numpy(toks).long(), tcache, tc)
    for name in ("k", "v"):
        tv = getattr(tcache["units"]["layer_00"], name)
        jv = getattr(jcache["units"]["layer_00"], name)
        assert tv.dtype == torch.float8_e4m3fn
        a, b = _np(tv), _np(jv)
        np.testing.assert_allclose(a, b, rtol=2 ** -3, atol=2 ** -9)
        assert np.mean(a != b) < 0.01


def test_port_init_shapes_dtypes_and_statistics():
    """The port cannot replay jax.random: its own init matches the
    reference's spec tree in structure, shapes and dtypes, and each leaf's
    statistics match its ParamSpec (zeros, ones, normal:0.02, fanin =
    1/sqrt(leading dim), as the reference reads it for stacked leaves)."""
    cfg = tbase.get_config("qwen2_0_5b", smoke=True)
    tp = tt.init(0, cfg, device="cpu")
    again = tt.init(0, cfg, device="cpu")
    js = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0),
                                        jbase.get_config("qwen2_0_5b",
                                                         smoke=True)))
    jl, tl = dict(_leaves(js)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    specs = dict(_leaves(tt.model_spec(cfg)))
    for path, t in tl.items():
        assert tuple(t.shape) == tuple(jl[path].shape), path
        assert t.dtype == torch.float32 and jl[path].dtype == jnp.float32
        assert torch.equal(t, dict(_leaves(again))[path])
        spec = specs[path]
        kind, _, arg = spec.init.partition(":")
        if kind in ("zeros", "ones"):
            assert torch.all(t == (kind == "ones")), path
            continue
        std = float(arg) if kind == "normal" else spec.shape[0] ** -0.5
        n = t.numel()
        # Sample std within 5 standard errors; mean within 5 of its own.
        assert abs(t.std().item() / std - 1) < 5 / np.sqrt(2 * n), path
        assert abs(t.mean().item()) < 5 * std / np.sqrt(n), path


def test_markov_lm_equal():
    for vocab, seed in ((512, 0), (151936, 3)):
        j, t = JMarkov(vocab, seed=seed), TMarkov(vocab, seed=seed)
        np.testing.assert_array_equal(t.sample(3, 40, seed=7),
                                      j.sample(3, 40, seed=7))
        jb, tb = j.batch(2, 16, step=5, shard=1, n_shards=2), \
            t.batch(2, 16, step=5, shard=1, n_shards=2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])


def test_unported_layer_kinds_raise():
    """mamba and rwkv layers and MoE MLPs (once A11) build the reference's
    spec tree, stacked and unstacked: the same leaves, shapes, logical
    axes and inits; a frontend stub and cross-attention, ported with
    whisper, build the reference's tree and compute its cross-attention
    (float32, 1e-6)."""
    cfg = tbase.get_config("qwen2_0_5b", smoke=True)

    def spec_tree(spec):
        return {p: (tuple(v.shape), tuple(v.axes), v.init)
                for p, v in _leaves(spec)}

    for extra in (dict(layer_pattern=("mamba",),
                       mamba=tbase.MambaConfig(d_state=8)),
                  dict(moe=tbase.MoEConfig(n_experts=4, top_k=2,
                                           d_expert=32, d_shared=64)),
                  dict(layer_pattern=("attn", "mamba"), scan_layers=False,
                       mamba=tbase.MambaConfig(), moe=tbase.MoEConfig(
                           n_experts=4, top_k=2, d_expert=32, every=2,
                           offset=1)),
                  dict(layer_pattern=("rwkv",), rwkv=tbase.RWKVConfig(
                      head_size=32, decay_lora=16, mix_lora=8))):
        jextra = {k: (getattr(jbase, type(v).__name__)(
            **dataclasses.asdict(v)) if dataclasses.is_dataclass(v) else v)
            for k, v in extra.items()}
        jspec = jt.model_spec(jbase.get_config("qwen2_0_5b", smoke=True)
                              .replace(**jextra))
        tspec = tt.model_spec(cfg.replace(**extra))
        assert spec_tree(tspec) == spec_tree(jspec), sorted(extra)
    jc = jbase.get_config("qwen2_0_5b", smoke=True).replace(frontend="x")
    tspec = tt.model_spec(cfg.replace(frontend="x"))
    jspec = jt.model_spec(jc)
    assert {p: tuple(v.shape) for p, v in _leaves(tspec)} == {
        p: tuple(v.shape) for p, v in _leaves(jspec)}
    rng = np.random.default_rng(8)
    jp = jcommon.init_params(jax.random.PRNGKey(2),
                             jattn.attn_spec(jc, cross=True))
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    mem = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jkv = jattn.encode_memory_kv(jp, jnp.asarray(mem), jc)
    want = jattn.cross_attend(jp, jnp.asarray(x), jkv, jc)
    tkv = tattn.encode_memory_kv(tp, torch.from_numpy(mem), cfg)
    got = tattn.cross_attend(tp, torch.from_numpy(x), tkv, cfg)
    for a, b in zip(tkv, jkv, strict=True):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
