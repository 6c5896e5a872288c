"""repro_torch's optimizer, loader, watchdog and straight-through
quantizers against the JAX reference on the CPU.

``apply_updates`` and ``compress_decompress`` run on the same numpy
params, gradients and state on both sides; every float32 output is held
to 2 float32 ulps (cos, pow and the norm's sums may round one ulp apart
between XLA and torch), bfloat16 ones to 1 bfloat16 ulp, integer ones
exactly. The loader and the watchdog mirror tests/test_fault_tolerance.py
and tests/test_optim_data.py; the quantizers' values and gradients are
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.data.synthetic import MarkovLM as JMarkov
from repro.optim import adamw as jadamw
from repro.train.trainer import StragglerWatchdog as JWatchdog
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core import quant as tquant
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.data import MarkovLM, ShardedLoader
from repro_torch.optim import adamw
from repro_torch.train import StragglerWatchdog, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _close(t, j, what):
    t_np, j_np = _np(t), _np(j)
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        np.testing.assert_allclose(t_np, j_np, rtol=2.0 ** -7, atol=0,
                                   err_msg=what)
    elif t_np.dtype.kind == "f":
        np.testing.assert_array_max_ulp(t_np, j_np, maxulp=2)
    else:
        np.testing.assert_array_equal(t_np, j_np, err_msg=what)


def _tree(rng, dtype=np.float32, pos=False):
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 3)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        x = rng.standard_normal(s).astype(np.float32)
        return np.abs(x) * 1e-3 if pos else x
    return make(shapes)


def _both(tree, jdtype=jnp.float32, tdtype=torch.float32):
    return (jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree),
            adamw.tree_map(lambda a: torch.from_numpy(a).to(tdtype), tree))


CFGS = [
    dict(),  # defaults: cosine, clip 1.0 (the gradients here are clipped)
    dict(lr=0.1, beta2=0.999, weight_decay=0.0, grad_clip=1e9,
         warmup_steps=0, schedule="constant"),
    dict(lr=1e-2, warmup_steps=4, total_steps=20, schedule="linear",
         grad_clip=50.0),
    dict(lr=2e-3, warmup_steps=20, total_steps=400, weight_decay=1e-4,
         schedule="cosine", grad_clip=1e9),
]


@pytest.mark.parametrize("step", [0, 3, 25])
@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_apply_updates_matches_reference(ci, step):
    rng = np.random.default_rng(ci * 10 + step)
    p, g = _tree(rng), _tree(rng)
    m, v = _tree(rng), _tree(rng, pos=True)
    jc = jadamw.OptimizerConfig(**CFGS[ci])
    tc = adamw.OptimizerConfig(**CFGS[ci])
    (jp, tp), (jg, tg), (jm, tm), (jv, tv) = map(_both, (p, g, m, v))
    js = jadamw.AdamWState(jnp.asarray(step, jnp.int32), jm, jv)
    ts = adamw.AdamWState(torch.tensor(step, dtype=torch.int32), tm, tv)
    with jax.disable_jit():
        jnew, jstate, jmet = jadamw.apply_updates(jp, jg, js, jc)
    tnew, tstate, tmet = adamw.apply_updates(tp, tg, ts, tc)
    for a, b, what in ((tnew, jnew, "params"), (tstate.m, jstate.m, "m"),
                       (tstate.v, jstate.v, "v")):
        for x, y in zip(adamw.tree_leaves(a), jax.tree.leaves(b),
                        strict=True):
            _close(x, y, what)
    assert int(tstate.step) == int(jstate.step) == step + 1
    _close(tmet["grad_norm"], jmet["grad_norm"], "grad_norm")
    _close(tmet["lr"], jmet["lr"], "lr")
    assert torch.equal(tp["a"], torch.from_numpy(p["a"]))  # functional


def test_apply_updates_bfloat16_state_matches_reference():
    rng = np.random.default_rng(9)
    p, g = _tree(rng), _tree(rng)
    jp, tp = _both(p, jnp.bfloat16, torch.bfloat16)
    jg, tg = _both(g, jnp.bfloat16, torch.bfloat16)
    jc, tc = (mod.OptimizerConfig(warmup_steps=0, schedule="constant")
              for mod in (jadamw, adamw))
    js = jadamw.init_state(jp, dtype=jnp.bfloat16)
    ts = adamw.init_state(tp, dtype=torch.bfloat16)
    with jax.disable_jit():
        for _ in range(3):
            jp, js, _ = jadamw.apply_updates(jp, jg, js, jc)
    for _ in range(3):
        tp, ts, _ = adamw.apply_updates(tp, tg, ts, tc)
    assert ts.m["a"].dtype == tp["a"].dtype == torch.bfloat16
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for x, y in zip(adamw.tree_leaves(tree_t), jax.tree.leaves(tree_j),
                        strict=True):
            _close(x, y, "bf16")


@pytest.mark.parametrize("steps", [1, 5])
def test_compress_decompress_matches_reference(steps):
    rng = np.random.default_rng(steps)
    jc, tc = (jadamw.init_compression(_both(_tree(rng))[0]),
              adamw.init_compression(_both(_tree(rng))[1]))
    for _ in range(steps):
        jg, tg = _both(_tree(rng))
        with jax.disable_jit():
            jq, jc, jm = jadamw.compress_decompress(jg, jc)
        tq, tc, tm = adamw.compress_decompress(tg, tc)
        for x, y in zip(adamw.tree_leaves(tq), jax.tree.leaves(jq),
                        strict=True):
            _close(x, y, "dequantized")
        for x, y in zip(adamw.tree_leaves(tc.residual),
                        jax.tree.leaves(jc.residual), strict=True):
            np.testing.assert_allclose(_np(x), _np(y), rtol=0, atol=1e-7)
        np.testing.assert_allclose(float(tm["compress_err_sq"]),
                                   float(jm["compress_err_sq"]), rtol=1e-5)


def test_error_feedback_preserves_mean_update():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=64)
                               .astype(np.float32))}
    comp = adamw.init_compression(g)
    total = torch.zeros_like(g["w"])
    for _ in range(50):
        gq, comp, _ = adamw.compress_decompress(g, comp)
        total = total + gq["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               atol=1e-3)


def test_schedule_clip_decay_and_convergence():
    cfg = adamw.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110,
                                schedule="cosine", min_lr_frac=0.1)
    lr = [float(adamw.schedule_lr(cfg, torch.tensor(s)))
          for s in (0, 5, 10, 110)]
    assert lr[0] == 0.0 and lr[1] == pytest.approx(0.5)
    assert lr[2] == pytest.approx(1.0) and lr[3] == pytest.approx(0.1,
                                                                   abs=1e-6)
    clipped, norm = adamw.clip_by_global_norm(
        {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.sqrt(clipped["a"] ** 2 + clipped["b"] ** 2)
                 ) == pytest.approx(1.0, rel=1e-5)
    dec = adamw.OptimizerConfig(lr=0.1, weight_decay=0.5, grad_clip=1e9,
                                warmup_steps=0, schedule="constant")
    p = {"w": torch.tensor([2.0])}
    new_p, _, _ = adamw.apply_updates(p, {"w": torch.tensor([0.0])},
                                      adamw.init_state(p), dec)
    assert float(new_p["w"][0]) == pytest.approx(2.0 - 0.1 * 0.5 * 2.0)
    quad = adamw.OptimizerConfig(lr=0.05, weight_decay=0.0, grad_clip=1e9,
                                 warmup_steps=0, schedule="constant")
    p = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(p)
    for _ in range(300):
        p, state, _ = adamw.apply_updates(p, {"w": 2 * p["w"]}, state, quad)
    assert float(p["w"].abs().max()) < 0.05


# ---------------------------------------------------------------------------
# Loader and watchdog
# ---------------------------------------------------------------------------


def test_loader_prefetch_reissue_and_reference_stream():
    lm = MarkovLM(97, seed=0)
    loader = ShardedLoader(
        lambda s, sh, n: lm.batch(2, 8, s, shard=sh, n_shards=n),
        shard=0, n_shards=4)
    assert [next(loader)[0] for _ in range(3)] == [0, 1, 2]
    loader.reissue(step=0, failed_shard=3)
    sid, injected = next(loader)
    assert sid == -1
    want = JMarkov(97, seed=0).batch(2, 8, 0, shard=3, n_shards=4)
    np.testing.assert_array_equal(injected["tokens"], want["tokens"])
    assert next(loader)[0] == 3
    loader.close()
    resumed = ShardedLoader(lambda s, sh, n: lm.batch(1, 4, s),
                            start_step=4)
    step, batch = next(resumed)
    np.testing.assert_array_equal(batch["tokens"],
                                  JMarkov(97, seed=0).batch(1, 4, 4)["tokens"])
    assert step == 4
    resumed.close()


@pytest.mark.parametrize("factor, ema, times", [
    (2.0, 0.9, [(1.0, {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0})] * 5
     + [(1.0, {0: 1.0, 1: 5.0, 2: 1.0, 3: 1.0})]),
    (3.0, 0.5, [(1.0, None)] + [(4.0, None)] * 7 + [(4.0, {0: 4.0})]),
    (3.0, 0.9, [(1.0, None), (1.0, None), (9.0, None), (1.0, None)]),
])
def test_watchdog_matches_reference(factor, ema, times):
    kw = dict(straggler_factor=factor, straggler_ema=ema)
    jw, tw = JWatchdog(JTrainerConfig(**kw)), StragglerWatchdog(
        TrainerConfig(**kw))
    for step, (sec, shards) in enumerate(times):
        assert tw.observe(step, sec, shards) == jw.observe(step, sec, shards)
    assert tw.flagged == jw.flagged and tw.ema == pytest.approx(jw.ema)


# ---------------------------------------------------------------------------
# Straight-through quantizers
# ---------------------------------------------------------------------------


def _vjp_both(jfn, tfn, x, g):
    jy, pull = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = pull(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    ty = tfn(xt)
    (tg,) = torch.autograd.grad(ty, xt, torch.from_numpy(g))
    return (np.asarray(jy), ty.detach().numpy()), (np.asarray(jg),
                                                   tg.numpy())


@pytest.mark.parametrize("symmetric", [False, True])
def test_fake_quant_acts_values_and_gradients(symmetric):
    rng = np.random.default_rng(int(symmetric))
    x = rng.standard_normal((6, 9)).astype(np.float32)
    if symmetric:
        x = np.abs(x)
    g = rng.standard_normal(x.shape).astype(np.float32)
    with jax.disable_jit():
        (jy, ty), (jg, tg) = _vjp_both(
            lambda a: jquant.fake_quant_acts(a, JOP, symmetric=symmetric),
            lambda a: tquant.fake_quant_acts(a, TOP, symmetric=symmetric),
            x, g)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


def test_fake_quant_weights_and_ste_ops():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 16, 5)).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    with jax.disable_jit():
        (jy, ty), (jg, tg) = _vjp_both(
            lambda a: jquant.fake_quant_weights(a, JOP),
            lambda a: tquant.fake_quant_weights(a, TOP), w, g)
        (jr, tr), (jrg, trg) = _vjp_both(
            lambda a: jquant.ste_clip(jquant.ste_round(a * 3), -2.0, 2.0),
            lambda a: tquant.ste_clip(tquant.ste_round(a * 3), -2.0, 2.0),
            w, g)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(trg, jrg)
    # the gradient passes where the rounded value lies in the clip range
    inside = np.abs(np.round(w * 3)) <= 2
    np.testing.assert_array_equal(trg, np.where(inside, g * np.float32(3),
                                                0))
