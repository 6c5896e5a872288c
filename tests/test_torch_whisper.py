"""repro_torch's encoder-decoder (whisper) and VLM frontend stub
(internvl2) against the JAX reference on the CPU, at SMOKE size.

The reference's parameters come from its own ``transformer.init`` and are
carried across with ``convert.to_torch``. Bit-exact checks run the
reference eagerly (``jax.disable_jit``), as tests/test_torch_transformer.py
explains; the port's cim-kernel is B1's plain version on the CPU, held to
the reference's cim. Tolerances are stated per test.
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
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt

B, S, MAX, STEPS = 2, 8, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper():
    """whisper SMOKE: the reference's params, frames and prompts."""
    cfg = jbase.get_config("whisper_tiny", smoke=True)
    jp = jt.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    return {
        "jparams": jp,
        "frames": (0.1 * rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model))).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
    }


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _cfgs(arch, mode, act):
    jc = jbase.get_config(arch, smoke=True).replace(activation_dtype=act)
    tc = tbase.get_config(arch, smoke=True).replace(activation_dtype=act)
    if mode != "fp":
        jc = jc.replace(cim=JPolicy(mode="cim" if mode == "cim-kernel"
                                    else mode, cim=JOP))
        tc = tc.replace(cim=TPolicy(mode=mode, cim=TOP))
    return jc, tc


def _params(jparams, jc):
    """The reference's tree (planned eagerly under a CIM mode) and the
    same carried across."""
    if jc.cim.mode != "fp":
        with jax.disable_jit():
            jparams = jengine.plan_params(jparams, policy=jc.cim)
    return jparams, convert.to_torch(jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _record(monkeypatch, module, calls):
    real = module.execute

    def rec(x, plan, policy, **kw):
        y = real(x, plan, policy, **kw)
        calls.append((x, plan, y))
        return y

    monkeypatch.setattr(module, "execute", rec)
    return real


def _macro_outputs_equal(jcalls, tcalls, execute, policy):
    """Each projection's macro output, bit for bit: the port's plan run on
    the reference's own input (identical activation codes)."""
    assert len(jcalls) == len(tcalls) > 0
    for (jx, _, jy), (_, tplan, _) in zip(jcalls, tcalls, strict=True):
        x = convert.to_torch(np.asarray(jx), device="cpu")
        np.testing.assert_array_equal(_np(execute(x, tplan, policy)),
                                      _np(jy))


@pytest.mark.parametrize("mode", ["fp", "cim-exact", "cim"])
def test_encode_and_cross_attention_bit_exact(whisper, mode, monkeypatch):
    """bfloat16: the encoder output, layer 0's cross-attention K/V and its
    cross-attention output equal the reference's bit for bit, and so does
    every projection's macro output (2 encoder layers x 6 projections,
    then wk, wv, wq, wo)."""
    jc, tc = _cfgs("whisper_tiny", mode, "bfloat16")
    jp, tp = _params(whisper["jparams"], jc)
    jcalls, tcalls = [], []
    _record(monkeypatch, jengine, jcalls)
    execute = _record(monkeypatch, tengine, tcalls)
    fr = jnp.asarray(whisper["frames"], jnp.bfloat16)
    rng = np.random.default_rng(1)
    hx = rng.standard_normal((B, 3, jc.d_model)).astype(np.float32)
    jhx, thx = jnp.asarray(hx, jnp.bfloat16), torch.from_numpy(hx).to(
        torch.bfloat16)
    jx = jp["units"]["layer_00"]["xattn"]
    jx = jax.tree.map(lambda a: a[0], jx)  # unit 0 of the stacked layer
    tx = tt._unit(tp["units"], 0)["layer_00"]["xattn"]
    with jax.disable_jit():
        jmem = jt.encode(jp, fr, jc, jc.cim)
        jkv = jattn.encode_memory_kv(jx, jmem, jc, policy=jc.cim)
        jout = jattn.cross_attend(jx, jhx, jkv, jc, policy=jc.cim)
    with torch.no_grad():
        tmem = tt.encode(tp, convert.to_torch(np.asarray(fr), device="cpu"),
                         tc, tc.cim)
        tkv = tattn.encode_memory_kv(tx, tmem, tc, policy=tc.cim)
        tout = tattn.cross_attend(tx, thx, tkv, tc, policy=tc.cim)
    assert tmem.dtype == torch.bfloat16
    for got, want in ((tmem, jmem), (tkv[0], jkv[0]), (tkv[1], jkv[1]),
                      (tout, jout)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))
    if mode == "fp":
        assert not jcalls and not tcalls
        return
    assert len(tcalls) == 2 * 6 + 4
    _macro_outputs_equal(jcalls, tcalls, execute, tc.cim)


def _serve_ref(jp, jc, frames, toks, steps, pos0=S):
    with jax.disable_jit():
        mem = jt.encode(jp, frames, jc, jc.cim)
        cache = jt.init_caches(jc, B, MAX, dtype=jnp.dtype(
            jc.activation_dtype))
        lg, cache = jt.prefill(jp, jnp.asarray(toks), cache, jc, memory=mem)
        out = [lg]
        for i in range(steps):
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            lg, cache = jt.decode_step(jp, tok, jnp.asarray(pos0 + i,
                                                            jnp.int32),
                                       cache, jc, memory=mem)
            out.append(lg)
    return [_np(o) for o in out]


def _serve_port(tp, tc, frames, toks, steps, pos0=S):
    with torch.no_grad():
        mem = tt.encode(tp, frames, tc, tc.cim)
        cache = tt.init_caches(tc, B, MAX, dtype=getattr(
            torch, tc.activation_dtype), device="cpu")
        lg, cache = tt.prefill(tp, torch.from_numpy(toks).long(), cache, tc,
                               memory=mem)
        out = [lg]
        for i in range(steps):
            lg, cache = tt.decode_step(tp, torch.argmax(lg, -1), pos0 + i,
                                       cache, tc, memory=mem)
            out.append(lg)
    return [_np(o) for o in out]


@pytest.mark.parametrize("mode", ["fp", "cim-exact", "cim", "cim-kernel"])
def test_serve_with_memory_matches_reference(whisper, mode, monkeypatch):
    """encode -> prefill(memory=) -> 3 greedy decode_step(memory=): the
    reference's greedy tokens. fp: bfloat16, logits within 3e-2 (a few
    bfloat16 steps of O(1) logits). CIM modes: float32 activations, every
    projection's macro output bit for bit (encoder 12, then per step 2
    layers x 10: wk, wv of the memory, wq, wk, wv, wo, cross wq, wo, up,
    down)."""
    act = "bfloat16" if mode == "fp" else "float32"
    jc, tc = _cfgs("whisper_tiny", mode, act)
    jp, tp = _params(whisper["jparams"], jc)
    jcalls, tcalls = [], []
    _record(monkeypatch, jengine, jcalls)
    execute = _record(monkeypatch, tengine, tcalls)
    fr = whisper["frames"]
    want = _serve_ref(jp, jc, jnp.asarray(fr, jnp.dtype(act)),
                      whisper["tokens"], STEPS)
    got = _serve_port(tp, tc, torch.from_numpy(fr).to(getattr(torch, act)),
                      whisper["tokens"], STEPS)
    for w_, g_ in zip(want, got, strict=True):
        np.testing.assert_array_equal(g_.argmax(-1), w_.argmax(-1))
        if mode == "fp":
            np.testing.assert_allclose(g_, w_, atol=3e-2, rtol=3e-2)
    if mode == "fp":
        return
    assert len(tcalls) == 12 + (1 + STEPS) * 2 * 10
    _macro_outputs_equal(jcalls, tcalls, execute, tc.cim)


def test_teacher_forced_serving_matches_forward(whisper):
    """tests/test_serving.py's check on the port, float32: prefill of 20
    tokens and 4 teacher-forced decode steps with memory= give the
    forward's logits (atol 5e-4, rtol 1e-3), and the forward equals the
    reference's (1e-4)."""
    jc, tc = _cfgs("whisper_tiny", "fp", "float32")
    tp = convert.to_torch(jax.tree.map(np.asarray, whisper["jparams"]),
                          device="cpu")
    n = 24
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, n))
    fr = whisper["frames"]
    want, _ = jt.forward_train(whisper["jparams"], {
        "tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(fr)}, jc)
    ttoks = torch.from_numpy(toks).long()
    with torch.no_grad():
        full, aux = tt.forward_train(tp, {
            "tokens": ttoks, "encoder_frames": torch.from_numpy(fr)}, tc)
        np.testing.assert_allclose(full.numpy(), _np(want), atol=1e-4,
                                   rtol=1e-4)
        mem = tt.encode(tp, torch.from_numpy(fr), tc, tc.cim)
        cache = tt.init_caches(tc, B, n, dtype=torch.float32, device="cpu")
        lg, cache = tt.prefill(tp, ttoks[:, :-4], cache, tc, memory=mem)
        np.testing.assert_allclose(lg.numpy(), full[:, n - 5].numpy(),
                                   atol=5e-4, rtol=1e-3)
        for t in range(4):
            lg, cache = tt.decode_step(tp, ttoks[:, n - 4 + t], n - 4 + t,
                                       cache, tc, memory=mem)
            np.testing.assert_allclose(lg.numpy(), full[:, n - 4 + t].numpy(),
                                       atol=5e-4, rtol=1e-3,
                                       err_msg=f"step {t}")
    assert float(aux) == 0.0


def test_decode_clamps_position_past_max_seq_len(whisper):
    """decode_step at pos >= max_seq_len (SMOKE: 256) reads the last
    learned position, as the reference's dynamic_slice clamps (RoPE and
    the cache slot still see pos): the reference's logits at 255, 256 and
    300 (float32, 1e-5), and the position added at 256 and 300 is row
    255's."""
    jc, tc = _cfgs("whisper_tiny", "fp", "float32")
    jp = whisper["jparams"]
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    fr = whisper["frames"]
    toks = whisper["tokens"]
    for pos in (255, 256, 300):
        want = _serve_ref(jp, jc, jnp.asarray(fr), toks, 1, pos0=pos)[-1]
        got = _serve_port(tp, tc, torch.from_numpy(fr), toks, 1,
                          pos0=pos)[-1]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    x = torch.zeros((B, 1, tc.d_model))
    last = tp["pos_emb"][tc.max_seq_len - 1]
    for pos in (255, 256, 300):
        assert torch.equal(tt._add_pos(tp, x, tc, pos)[:, 0],
                           last.expand(B, -1))


@pytest.mark.parametrize("mode", ["fp", "cim-exact"])
def test_internvl2_frontend_forward_matches_reference(mode):
    """internvl2 SMOKE: forward_train with 8 patch embeddings prepended to
    6 text tokens gives logits over all 14 positions, the reference's
    within 1e-4 (float32; fp, and cim-exact with every projection's
    integer product exact); the text-only prefill equals the forward's
    last position without the patches."""
    jc, tc = _cfgs("internvl2_2b", mode, "float32")
    jp, tp = _params(jt.init(jax.random.PRNGKey(4), jc), jc)
    rng = np.random.default_rng(3)
    fe = rng.standard_normal((B, jc.frontend_seq, jc.d_model)).astype(
        np.float32)
    toks = rng.integers(0, jc.vocab_size, (B, 6))
    want, _ = jt.forward_train(jp, {"tokens": jnp.asarray(toks),
                                    "frontend_embeds": jnp.asarray(fe)}, jc)
    with torch.no_grad():
        got, _ = tt.forward_train(tp, {
            "tokens": torch.from_numpy(toks).long(),
            "frontend_embeds": torch.from_numpy(fe)}, tc)
        text, _ = tt.forward_train(tp, {"tokens": torch.from_numpy(toks)
                                        .long()}, tc)
        cache = tt.init_caches(tc, B, 8, dtype=torch.float32, device="cpu")
        last, _ = tt.prefill(tp, torch.from_numpy(toks).long(), cache, tc)
    assert got.shape == (B, jc.frontend_seq + 6, tc.padded_vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(last.numpy(), text[:, -1].numpy(), atol=1e-5,
                               rtol=1e-5)
