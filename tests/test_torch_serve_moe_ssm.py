"""Serving the MoE, RWKV-6 and Mamba (jamba) families: repro_torch's
``init_caches`` -> ``prefill`` -> ``decode_step`` and ``ServeEngine``
against the JAX reference on the CPU, on the four SMOKE configs
(granite-moe, qwen2-moe, rwkv6, jamba) with the reference's parameters
carried across.

The reference runs eagerly (``jax.disable_jit``), bfloat16 activations
(the configs'), batch 2, 6-token prompts, 3 greedy decode steps. Under
the CIM modes the MoE archs are served by the reference's unplanned
engine (``plan=False``: its planned expert banks cannot be indexed; the
port serves the planned tree, reading each expert as a view of the
bank), the others by its planned one. The port's cim-kernel (on the CPU:
B1's plain version) is held to the reference's cim.

What is held:
- every macro projection's output, bit for bit, on the reference's own
  input (the port fed the reference's tokens);
- the logits of each step within 0.1 (logits of magnitude up to ~4: the
  digital attention core, the recurrences' exp/tanh and the softmax
  round an ulp apart in float32; rounded to bfloat16, a state that is
  stored in bfloat16 between steps carries such a flip on, about 0.06 in
  rwkv6's logits by the third step);
- ``ServeEngine.generate``'s greedy tokens equal to the reference's: all
  of them under the CIM modes, under fp up to the first step where the
  reference's two best logits lie within that tolerance of each other;
- the caches: the same tree, types and dtypes (the stacked recurrent
  states rounded back to bfloat16 after every step; a Mamba tail's ssm
  state float32 from its first decode step, ``scan_layers=False``), the
  values within 5% of each tensor's largest magnitude (the Mamba states
  reach 3e4 with elements that cancel near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CIMPolicy as JPolicy
from repro.configs.base import get_config as jget
from repro.core import engine as jengine
from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.configs.base import get_config as tget
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as tt
from repro_torch.models.attention import KVCache
from repro_torch.serve import engine as tserve

ARCHS = ("granite_moe_1b", "qwen2_moe_a2_7b", "rwkv6_1_6b",
         "jamba_1_5_large")
MODES = ("fp", "cim-exact", "cim", "cim-kernel")
B, S, STEPS, MAX = 2, 6, 3, 12
TOL = 0.1
CACHE_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


_PARAMS: dict = {}
_REF: dict = {}


def _params(arch, **kw):
    """The reference's parameters of the SMOKE config (with ``kw``)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        _PARAMS[key] = jt.init(jax.random.PRNGKey(0),
                               jget(arch, smoke=True).replace(**kw))
    return _PARAMS[key]


def _cfgs(arch, mode, **kw):
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    if mode != "fp":
        jc = jc.replace(cim=JPolicy(mode="cim" if mode == "cim-kernel"
                                    else mode, cim=JOP))
        tc = tc.replace(cim=TPolicy(mode=mode, cim=TOP))
    return jc.replace(**kw), tc.replace(**kw)


def _prompts(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))


def _record(module, calls):
    real = module.execute

    def rec(x, plan, policy, **kw):
        y = real(x, plan, policy, **kw)
        calls.append((x, plan, y))
        return y

    module.execute = rec
    return real


def _reference(arch, mode, **kw):
    """The reference's eager greedy run: (plan flag, params it served,
    logits per step, tokens [B, 1 + STEPS], execute calls, final caches).
    cim-kernel shares cim's run."""
    key = (arch, "cim" if mode == "cim-kernel" else mode,
           tuple(sorted(kw.items())))
    if key in _REF:
        return _REF[key]
    jc, _ = _cfgs(arch, mode, **kw)
    jp = _params(arch, **kw)
    plan = not (jc.moe is not None and mode != "fp")
    calls = []
    real = _record(jengine, calls)
    try:
        with jax.disable_jit():
            if plan:
                jp = jengine.plan_params(jp, policy=jc.cim)
            calls.clear()
            cache = jt.init_caches(jc, B, MAX, dtype=jnp.bfloat16)
            lg, cache = jt.prefill(jp, jnp.asarray(_prompts(jc), jnp.int32),
                                   cache, jc)
            logits = [lg]
            for i in range(STEPS):
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                lg, cache = jt.decode_step(jp, tok, jnp.asarray(S + i,
                                                                jnp.int32),
                                           cache, jc)
                logits.append(lg)
    finally:
        jengine.execute = real
    logits = [_np(lg) for lg in logits]
    toks = np.stack([lg.argmax(-1) for lg in logits], 1)
    _REF[key] = (plan, jp, logits, toks, calls, cache)
    return _REF[key]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            yield path + (type(tree).__name__, f), v
    else:
        yield path, tree


def _port_params(plan, jp, tc):
    """The port's served tree: the reference's plan carried across, or
    (MoE under CIM) the reference's parameters planned by the port."""
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    if not plan:
        tp = tengine.plan_params(tp, policy=tc.cim)
    return tp


def _check_caches(tcache, jcache):
    want = {p: v for p, v in _leaves(jcache)}
    got = {p: v for p, v in _leaves(tcache)}
    assert got.keys() == want.keys()
    for p, v in got.items():
        assert str(v.dtype).split(".")[-1] == str(want[p].dtype), p
        w = _np(want[p])
        np.testing.assert_allclose(
            _np(v), w, rtol=0, atol=CACHE_TOL * max(np.abs(w).max(), 1.0),
            err_msg=str(p))


def _first_close_step(logits):
    """The first step whose two best reference logits lie within TOL."""
    for i, lg in enumerate(logits):
        top2 = np.sort(lg, -1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] <= TOL).any():
            return i
    return len(logits)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference(arch, mode):
    jc, tc = _cfgs(arch, mode)
    plan, jp, want, want_toks, jcalls, jcache = _reference(arch, mode)
    tp = _port_params(plan, jp, tc)
    prompts = torch.from_numpy(_prompts(tc))

    # Teacher-forced on the reference's tokens, recording the macro calls.
    tcalls = []
    execute = _record(tengine, tcalls)
    try:
        cache = tt.init_caches(tc, B, MAX, device="cpu")
        with torch.no_grad():
            lg, cache = tt.prefill(tp, prompts, cache, tc)
            got = [lg]
            for i in range(STEPS):
                lg, cache = tt.decode_step(
                    tp, torch.from_numpy(want_toks[:, i]).long(), S + i,
                    cache, tc)
                got.append(lg)
    finally:
        tengine.execute = execute
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_allclose(_np(g), w, atol=TOL, rtol=TOL,
                                   err_msg=f"step {i}")
    _check_caches(cache, jcache)
    if mode == "fp":
        assert not jcalls and not tcalls
    else:
        assert len(tcalls) == len(jcalls) > 0
        for i, ((jx, _, jy), (tx, tplan, _)) in enumerate(
                zip(jcalls, tcalls, strict=True)):
            y = execute(torch.from_numpy(np.array(_np(jx))).to(tx.dtype),
                        tplan, tc.cim)
            np.testing.assert_array_equal(_np(y), _np(jy),
                                          err_msg=f"call {i}")

    # Greedy generation: both engines from the unplanned parameters; the
    # port plans them (the reference plans too, but for MoE under CIM).
    raw = convert.to_torch(jax.tree.map(np.asarray, _params(arch)),
                           device="cpu")
    eng = tserve.ServeEngine(raw, tc, max_len=MAX, batch=B, plan=True,
                             device="cpu")
    toks = eng.generate(prompts, 1 + STEPS)
    n = _first_close_step(want) if mode == "fp" else 1 + STEPS
    np.testing.assert_array_equal(toks[:, :n], want_toks[:, :n])


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "jamba_1_5_large"])
def test_unstacked_tail_layers_keep_their_state_dtypes(arch):
    """``scan_layers=False``: every layer is a tail. A Mamba tail's ssm
    state becomes float32 at its first decode step (the reference writes
    the layer's float32 state back without the stacked carry's cast); an
    RWKV tail casts to its cache dtype. Same dtypes, values within TOL,
    and the logits within TOL, cim-exact."""
    jc, tc = _cfgs(arch, "cim-exact", scan_layers=False)
    plan, jp, want, want_toks, _, jcache = _reference(arch, "cim-exact",
                                                      scan_layers=False)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    assert "units" not in tp and f"tail_{tc.n_layers - 1:02d}" in tp
    cache = tt.init_caches(tc, B, MAX, device="cpu")
    with torch.no_grad():
        lg, cache = tt.prefill(tp, torch.from_numpy(_prompts(tc)), cache, tc)
        got = [lg]
        for i in range(STEPS):
            lg, cache = tt.decode_step(
                tp, torch.from_numpy(want_toks[:, i]).long(), S + i, cache,
                tc)
            got.append(lg)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(g), w, atol=TOL, rtol=TOL)
    _check_caches(cache, jcache)
    kinds = {type(c).__name__: c for c in cache.values()}
    if arch == "jamba_1_5_large":
        assert kinds["MambaCache"].ssm.dtype == torch.float32
        assert kinds["MambaCache"].conv.dtype == torch.bfloat16
        assert isinstance(kinds["KVCache"], KVCache)
    else:
        assert kinds["RWKVCache"].state.dtype == torch.bfloat16


def test_convert_carries_the_recurrent_caches_and_new_leaves():
    """``convert.to_torch`` on the reference's jamba and rwkv caches after
    a prefill (MambaCache, RWKVCache and KVCache, stacked) and on their
    parameter trees (expert banks, a_log, mu_*, the LoRA mixers,
    bonus_u): the port's types, bit for bit."""
    for arch in ("jamba_1_5_large", "rwkv6_1_6b"):
        _, jp, _, _, _, jcache = _reference(arch, "fp")
        tcache = convert.to_torch(jax.tree.map(np.asarray, jcache),
                                  device="cpu")
        want = dict(_leaves(jcache))
        for path, v in _leaves(tcache):
            np.testing.assert_array_equal(_np(v), _np(want[path]))
        unit = tcache["units"]
        if arch == "jamba_1_5_large":
            assert isinstance(unit["layer_01"], tmamba.MambaCache)
            assert isinstance(unit["layer_00"], KVCache)
        else:
            assert isinstance(unit["layer_00"], trwkv.RWKVCache)
        params = _params(arch)
        tp = convert.to_torch(jax.tree.map(np.asarray, params), device="cpu")
        names = {p[-1] for p, _ in _leaves(tp)}
        new = ({"a_log", "gate", "up", "down", "conv_w", "d_skip"}
               if arch == "jamba_1_5_large" else
               {"mu_x", "mu_w", "mix_w1", "mix_w2", "decay_w1", "bonus_u"})
        assert new <= names
        for path, v in _leaves(tp):
            np.testing.assert_array_equal(
                _np(v), _np(dict(_leaves(params))[path]))


def test_cache_trees_and_kv_dtype_override():
    """init_caches builds the reference's tree: KV caches take
    kv_cache_dtype (float8 here), recurrent states the caller's dtype."""
    for arch in ARCHS:
        jc, tc = _cfgs(arch, "fp", kv_cache_dtype="float8_e4m3fn")
        want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _leaves(
            jt.init_caches(jc, B, MAX, dtype=jnp.bfloat16))}
        got = {p: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for p, v in _leaves(tt.init_caches(tc, B, MAX,
                                                   device="cpu"))}
        assert got == want, arch


def test_forward_train_sums_the_moe_aux():
    """forward_train returns the MoE aux summed over the layers (jamba:
    layers 1, 3, 5, 7), as the reference's (float32 activations, where
    the routing is the same: 1e-5), and the logits within TOL; its last
    position equals the prefill's."""
    jc, tc = _cfgs("jamba_1_5_large", "fp", activation_dtype="float32")
    jp = _params("jamba_1_5_large")
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _prompts(jc)
    with jax.disable_jit():
        want, jaux = jt.forward_train(jp, {"tokens": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        got, taux = tt.forward_train(tp, {"tokens": torch.from_numpy(toks)},
                                     tc)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 3  # four MoE layers, each near 1
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    with torch.no_grad():
        last, _ = tt.prefill(tp, torch.from_numpy(toks),
                             tt.init_caches(tc, B, MAX, dtype=torch.float32,
                                            device="cpu"), tc)
    np.testing.assert_allclose(_np(last), _np(got[:, -1]), atol=TOL,
                               rtol=TOL)
