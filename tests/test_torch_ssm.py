"""repro_torch's recurrent layers, RWKV-6 (models/rwkv.py) and Mamba
(models/mamba.py), against the JAX reference on the CPU.

Parameters come from the reference's ``init_params`` over its own specs
(the rwkv6 and jamba SMOKE configs), carried across with
``convert.to_torch``; inputs from numpy seeds. The reference runs eagerly
(``jax.disable_jit``). Tolerances: the recurrences and the float32 LoRA
mixers sum in another order and call another library's exp, tanh and
log1p (an ulp apart), so float32 results are held at 1e-5 relative (1e-4
where a state accumulates over 10-20 steps), bfloat16 results at one
bfloat16 step (2**-7 relative). Every macro projection's output is held
bit for bit on the reference's own input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.base import CIMPolicy as JPolicy
from repro.core import engine as jengine
from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.models import rwkv as jrwkv
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as tt

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16 = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.is_floating_point() \
            else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(_np(a)))
    return t if dtype is None else t.to(dtype)


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _spec_tree(spec):
    return {jax.tree_util.keystr(p): (tuple(s.shape), tuple(s.axes), s.init)
            for p, s in jax.tree_util.tree_leaves_with_path(
                spec, is_leaf=lambda s: hasattr(s, "axes"))}


def _params(jspec, seed):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jspec)
    return jp, convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _record(monkeypatch, module, calls):
    real = module.execute

    def rec(x, plan, policy, **kw):
        y = real(x, plan, policy, **kw)
        calls.append((x, plan, y))
        return y

    monkeypatch.setattr(module, "execute", rec)
    return real


def _replay(jcalls, tcalls, execute, policy):
    """Every macro projection: the port's execute on the reference's input
    and the port's plan gives the reference's output bit for bit."""
    assert len(jcalls) == len(tcalls) > 0
    for i, ((jx, _, jy), (tx, tplan, _)) in enumerate(
            zip(jcalls, tcalls, strict=True)):
        y = execute(_t(jx, tx.dtype), tplan, policy)
        np.testing.assert_array_equal(_np(y), _np(jy), err_msg=f"call {i}")


RW = "rwkv6_1_6b"
JA = "jamba_1_5_large"


@pytest.fixture(scope="module")
def rw():
    jc = jbase.get_config(RW, smoke=True)
    tc = tbase.get_config(RW, smoke=True)
    assert _spec_tree(trwkv.rwkv_spec(tc)) == _spec_tree(jrwkv.rwkv_spec(jc))
    assert _spec_tree(trwkv.channelmix_spec(tc)) == _spec_tree(
        jrwkv.channelmix_spec(jc))
    jtm, ttm = _params(jrwkv.rwkv_spec(jc), 0)
    jcm, tcm = _params(jrwkv.channelmix_spec(jc), 1)
    return dict(jc=jc, tc=tc, jtm=jtm, ttm=ttm, jcm=jcm, tcm=tcm)


@pytest.fixture(scope="module")
def ja():
    jc = jbase.get_config(JA, smoke=True)
    tc = tbase.get_config(JA, smoke=True)
    assert _spec_tree(tmamba.mamba_spec(tc)) == _spec_tree(
        jmamba.mamba_spec(jc))
    jp, tp = _params(jmamba.mamba_spec(jc), 2)
    # The S4D init, as transformer.init applies it.
    jp = jmamba.init_mamba_alog(jp, jc)
    tp["a_log"] = _t(jp["a_log"])
    return dict(jc=jc, tc=tc, jp=jp, tp=tp)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ddlerp_decay_and_group_norm(rw, dtype):
    """The token-shift interpolation (float32 params lift bfloat16
    activations to float32, as jnp promotes), the data-dependent decay and
    the per-head group norm."""
    rng = np.random.default_rng(0)
    d = rw["tc"].d_model
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    xp = rng.standard_normal((2, 5, d)).astype(np.float32)
    (jx, tx), (jxp, txp) = _pair(x, dtype), _pair(xp, dtype)
    with jax.disable_jit():
        jm = jrwkv._ddlerp(rw["jtm"], jx, jxp)
        jw = jrwkv._decay(rw["jtm"], jm["w"])
    tm = trwkv._ddlerp(rw["ttm"], tx, txp)
    tw = trwkv._decay(rw["ttm"], tm["w"])
    for nm in trwkv._MIX_NAMES:
        assert tm[nm].dtype == torch.float32 and jm[nm].dtype == jnp.float32
        _close(tm[nm], jm[nm], 1e-5, nm)
    assert tw.dtype == torch.float32
    _close(tw, jw, 1e-5, "decay")
    y = rng.standard_normal((2, 5, 4, 32)).astype(np.float32) * 3
    _close(trwkv._group_norm(rw["ttm"], torch.from_numpy(y), 1e-6),
           jrwkv._group_norm(rw["jtm"], jnp.asarray(y), 1e-6), 1e-5, "gn")


@pytest.mark.parametrize("chunk", [1, 4, 128])
def test_wkv_scan_chunks_and_padding(chunk):
    """The WKV recurrence over 10 steps: chunk 1 (decode), chunk 4 (two
    padded steps with r, k, v = 0 and w = 1) and one chunk of 128 (118
    padded): outputs and the final state as the reference's, and the same
    whatever the chunk."""
    rng = np.random.default_rng(1)
    b, l, h, hd = 2, 10, 3, 8
    r, k, v = (rng.standard_normal((b, l, h, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (b, l, h, hd)).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    s0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    with jax.disable_jit():
        jy, js = jrwkv._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                          s0)), chunk)
    ty, ts = trwkv._wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                            s0)), chunk)
    assert ty.shape == (b, l, h, hd) and ts.shape == (b, h, hd, hd)
    _close(ty, jy, 1e-4, "y")
    _close(ts, js, 1e-4, "state")
    y1, s1 = trwkv._wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                            s0)), 1)
    assert torch.equal(ty, y1) and torch.equal(ts, s1)


@pytest.mark.parametrize("mode", ["fp", "cim-exact", "cim-kernel"])
def test_timemix_and_channelmix_match_reference(rw, mode, monkeypatch):
    """bfloat16 activations with a carried shift and WKV state: r, k, v,
    g and o at apply_to_attn_proj, the channel-mix's k, v and r at
    apply_to_mlp; fp at one bfloat16 step for the bfloat16 shift and
    1e-4 for the float32 state and outputs, and the CIM modes'
    projections bit for bit on the reference's inputs (planned weights,
    the reference's plan)."""
    jc, tc = rw["jc"], rw["tc"]
    jpol = tpol = None
    jtm, jcm = rw["jtm"], rw["jcm"]
    ttm, tcm = rw["ttm"], rw["tcm"]
    if mode != "fp":
        jpol = JPolicy(mode="cim" if mode == "cim-kernel" else mode, cim=JOP)
        tpol = TPolicy(mode=mode, cim=TOP)
        with jax.disable_jit():
            jtm = jengine.plan_params(jtm, policy=jpol)
            jcm = jengine.plan_params(jcm, policy=jpol)
        ttm = convert.to_torch(jax.tree.map(np.asarray, jtm), device="cpu")
        tcm = convert.to_torch(jax.tree.map(np.asarray, jcm), device="cpu")
    rng = np.random.default_rng(2)
    d, (h, hd) = tc.d_model, trwkv._dims(tc)
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    sh = rng.standard_normal((2, d)).astype(np.float32)
    st = (rng.standard_normal((2, h, hd, hd)) * 0.1).astype(np.float32)
    (jx, tx), (jsh, tsh) = _pair(x, "bfloat16"), _pair(sh, "bfloat16")
    jcalls, tcalls = [], []
    _record(monkeypatch, jengine, jcalls)
    execute = _record(monkeypatch, tengine, tcalls)
    with jax.disable_jit():
        jo, js, jst = jrwkv.timemix_apply(jtm, jx, jc, shift_state=jsh,
                                          wkv_state=jnp.asarray(st), chunk=4,
                                          policy=jpol)
        jco, jcs = jrwkv.channelmix_apply(jcm, jx, jc, shift_state=jsh,
                                          policy=jpol)
    with torch.no_grad():
        to, ts, tst = trwkv.timemix_apply(ttm, tx, tc, shift_state=tsh,
                                          wkv_state=torch.from_numpy(st),
                                          chunk=4, policy=tpol)
        tco, tcs = trwkv.channelmix_apply(tcm, tx, tc, shift_state=tsh,
                                          policy=tpol)
    for got, want in ((to, jo), (tst, jst), (tco, jco)):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert torch.equal(ts, tx[:, -1]) and torch.equal(tcs, tx[:, -1])
    _close(to, jo, 1e-4, "timemix")
    _close(tst, jst, 1e-4, "state")
    _close(tco, jco, 1e-4, "channelmix")
    if mode == "fp":
        assert not jcalls and not tcalls
    else:
        assert len(tcalls) == 5 + 3
        _replay(jcalls, tcalls, execute, tpol)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def test_causal_conv_and_associative_scan():
    """The depthwise causal conv bit for bit in float32 (the same four
    products and adds), and the associative scan's combine tree: on the
    same (a, b) the port's equals lax.associative_scan bit for bit at
    every length up to 37, odd ones included."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        (jx, tx) = _pair(x, dt)
        want = jmamba._causal_conv(jx, jnp.asarray(w), jnp.asarray(b))
        got = tmamba._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), _np(want))
    for n in (1, 2, 3, 7, 16, 37):
        a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
        bb = rng.standard_normal((2, n, 3)).astype(np.float32)
        with jax.disable_jit():
            ja_, jb_ = jax.lax.associative_scan(
                jmamba_combine, (jnp.asarray(a), jnp.asarray(bb)), axis=1)
        ta, tb = tmamba.associative_scan((torch.from_numpy(a),
                                          torch.from_numpy(bb)), dim=1)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja_))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb_))


def jmamba_combine(p, q):
    (a1, b1), (a2, b2) = p, q
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("impl", ["sequential", "chunked"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_apply_and_decode_match_reference(ja, impl, dtype):
    """mamba_apply(return_cache=True) over 11 tokens (chunk 16 pads 5
    steps with dt = 0), then 3 mamba_decode_step's from its cache: the
    outputs, the conv window and the float32 ssm state."""
    jc, tc = ja["jc"], ja["tc"]
    jc = jc.replace(mamba=jc.mamba.__class__(**{
        **jc.mamba.__dict__, "scan_impl": impl}))
    tc = tc.replace(mamba=tc.mamba.__class__(**{
        **tc.mamba.__dict__, "scan_impl": impl}))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, tc.d_model)).astype(np.float32)
    steps = rng.standard_normal((3, 2, 1, tc.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tol = 1e-4 if dtype == "float32" else 2 * BF16
    with jax.disable_jit():
        jo, jcache = jmamba.mamba_apply(ja["jp"], jx, jc, return_cache=True)
        jouts = []
        for s in steps:
            y, jcache = jmamba.mamba_decode_step(
                ja["jp"], jnp.asarray(s, jx.dtype), jc, jcache)
            jouts.append(y)
    with torch.no_grad():
        to, tcache = tmamba.mamba_apply(ja["tp"], tx, tc, return_cache=True)
        assert tcache.conv.dtype == tcache.ssm.dtype == torch.float32
        touts = []
        for s in steps:
            y, tcache = tmamba.mamba_decode_step(
                ja["tp"], torch.from_numpy(s).to(tx.dtype), tc, tcache)
            touts.append(y)
    _close(to, jo, tol, "apply")
    for i, (a, b) in enumerate(zip(touts, jouts)):
        assert a.dtype == DTYPES[dtype][1] or a.dtype == torch.float32
        _close(a, b, tol, f"decode {i}")
    for f in ("conv", "ssm"):
        a, b = getattr(tcache, f), getattr(jcache, f)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f
        _close(a, b, tol, f)


def test_scans_agree_and_prompt_shorter_than_the_conv(ja):
    """The chunked scan equals the sequential one (float32, 1e-5); a
    2-token prompt leaves a left-padded conv window of d_conv - 1."""
    tc = ja["tc"]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 21, tc.d_model)).astype(
        np.float32))
    seq = tc.replace(mamba=tc.mamba.__class__(**{
        **tc.mamba.__dict__, "scan_impl": "sequential"}))
    with torch.no_grad():
        a = tmamba.mamba_apply(ja["tp"], x, tc)
        b = tmamba.mamba_apply(ja["tp"], x, seq)
        _, short = tmamba.mamba_apply(ja["tp"], x[:, :2], tc,
                                      return_cache=True)
    _close(a, b, 1e-5)
    jc = ja["jc"]
    with jax.disable_jit():
        _, jshort = jmamba.mamba_apply(ja["jp"], jnp.asarray(x[:, :2].numpy()),
                                       jc, return_cache=True)
    assert short.conv.shape == (2, tc.mamba.d_conv - 1, 2 * tc.d_model)
    assert torch.all(short.conv[:, 0] == 0)
    _close(short.conv, jshort.conv, 1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_a_log_s4d_init_on_every_leaf(param_dtype):
    """transformer.init's S4D-real init: every a_log leaf (the 7 stacked
    mamba layers of jamba SMOKE's unit, [1, d_in, d_state]) is
    log(1..d_state) along its last axis, as the reference's init gives
    it (to one float32 ulp), in the param dtype."""
    tc = tbase.get_config(JA, smoke=True).replace(param_dtype=param_dtype)
    jc = jbase.get_config(JA, smoke=True).replace(param_dtype=param_dtype)
    tp = tt.init(0, tc, device="cpu")
    js = jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), jc))
    jp = jt.init(jax.random.PRNGKey(0), jc)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(tp)}
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(jp)}
    shapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_leaves_with_path(js)}
    assert {k: tuple(v.shape) for k, v in got.items()} == shapes
    alog = [k for k in got if k.endswith("['a_log']")]
    assert len(alog) == 7
    for k in alog:
        assert got[k].dtype == getattr(torch, param_dtype)
        assert got[k].shape == (1, 2 * tc.d_model, tc.mamba.d_state)
        # torch's float32 log is correctly rounded; XLA's is one ulp off
        # at log(7).
        np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                   rtol=2.0 ** -23, atol=0, err_msg=k)
        base = np.log(np.arange(1, tc.mamba.d_state + 1, dtype=np.float64))
        np.testing.assert_array_equal(
            _np(got[k]), np.broadcast_to(_np(torch.from_numpy(base).to(
                got[k].dtype)), got[k].shape))
