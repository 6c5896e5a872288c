"""repro_torch's MoE block (models/moe.py) against the JAX reference on
the CPU: the router with ties, grouped dispatch with drops, the ragged
path, the dense CIM loop through the macro with the planned expert view,
the shared expert and ``moe_apply`` on the granite and qwen2-moe SMOKE
configs.

Inputs come from numpy seeds; parameters from the reference's
``init_params``, carried across with ``convert.to_torch``. The reference
runs eagerly (``jax.disable_jit``): bfloat16 results are compared bit for
bit (the port sums XLA's bfloat16 dots in float32 and rounds once, as XLA
does), float32 ones at 1e-5 (three chained matmuls of up to 128 terms,
summed in another order, on outputs up to ~20), router metrics at 1e-6
(float32 exp and log of two libraries). Every macro projection's
output is bit for bit on the reference's own input.
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
from repro.core.params import PAPER_OP_16ROWS as JOP
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_ARCHS = ("granite_moe_1b", "qwen2_moe_a2_7b")


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


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def _close(got, want, dtype, what=""):
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=what)


def _params(cfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jmoe.moe_spec(cfg))
    return jp, convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _cfgs(arch, **moe_kw):
    jc = jbase.get_config(arch, smoke=True)
    tc = tbase.get_config(arch, smoke=True)
    if moe_kw:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

# Logits rows (bfloat16-exact) with ties inside the top 4, at the 4th
# place, and everywhere.
TIE_ROWS = [
    [1, 2, 2, 3, 0, 0, 0, 0],  # 2 == 2 inside the top 4
    [5, 1, 1, 1, 4, 0, 0, 1],  # four 1s compete for places 3 and 4
    [0.5] * 8,  # all equal: experts 0..3
    [0, 0, 0, 0, 0, 0, 0, 7],
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_router_with_ties_matches_reference(dtype):
    """Ties go to the lower index (lax.top_k), inside the top k and at its
    boundary; top_p, aux loss and entropy as the reference's. One-hot
    inputs read the router's rows as the logits; random rows follow."""
    mo = tbase.MoEConfig(n_experts=8, top_k=4, d_expert=16)
    jmo = jbase.MoEConfig(n_experts=8, top_k=4, d_expert=16)
    rng = np.random.default_rng(0)
    d = 16
    w = np.zeros((d, 8), np.float32)
    w[:len(TIE_ROWS)] = TIE_ROWS
    w[len(TIE_ROWS):] = rng.standard_normal((d - len(TIE_ROWS), 8))
    x = np.concatenate([np.eye(d, dtype=np.float32),
                        rng.standard_normal((20, d)).astype(np.float32)])
    jx, tx = _pair(x, dtype)
    jp_, jte, jm = jmoe._router({"router": {"w": jnp.asarray(w)}}, jx, jmo)
    tp_, tte, tm = tmoe._router({"router": {"w": torch.from_numpy(w)}}, tx,
                                mo)
    np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
    assert tte[:3].tolist() == [[3, 1, 2, 0], [0, 4, 1, 2], [0, 1, 2, 3]]
    assert tp_.dtype == DTYPES[dtype][1]
    _close(tp_, jp_, dtype)
    for a, b in zip(tm, jm, strict=True):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # top_k_stable against lax.top_k on random ties.
    probs = rng.integers(0, 4, (64, 32)).astype(np.float32)
    vals, idx = tmoe.top_k_stable(torch.from_numpy(probs), 8)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_router_jitter_only_with_a_generator():
    mo = tbase.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                         router_jitter=0.5)
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    plain = tmoe._router({"router": {"w": w}},
                         x, dataclasses.replace(mo, router_jitter=0.0))
    no_gen = tmoe._router({"router": {"w": w}}, x, mo)
    jit1 = tmoe._router({"router": {"w": w}}, x, mo,
                        generator=torch.Generator().manual_seed(3))
    jit2 = tmoe._router({"router": {"w": w}}, x, mo,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(no_gen[1], plain[1]) and torch.equal(no_gen[0],
                                                            plain[0])
    assert torch.equal(jit1[1], jit2[1])
    assert not torch.equal(jit1[1], plain[1])


# ---------------------------------------------------------------------------
# Digital dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cf,group", [(0.5, 8), (1.25, 4096), (8.0, 12)],
                         ids=["drops", "one-group", "ragged-groups"])
def test_grouped_dispatch_matches_reference(cf, group, dtype):
    """Capacity with drops (two groups of 8 at capacity 2), the default
    single group, and a group size that does not divide the 20 tokens
    (fewer groups): the [G, E, C, d] dispatch and combine as the
    reference's."""
    jc, tc = _cfgs("granite_moe_1b", capacity_factor=cf, group_size=group)
    jp, tp = _params(jc, 1)
    t = 16 if group == 8 else 20
    x = np.random.default_rng(2).standard_normal((t, jc.d_model)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    with jax.disable_jit():
        jtp, jte, _ = jmoe._router(jp, jx, jc.moe)
        want = jmoe._dispatch_grouped(jp, jx, jtp, jte, jc.moe, jx.dtype)
    ttp, tte, _ = tmoe._router(tp, tx, tc.moe)
    got = tmoe._dispatch_grouped(tp, tx, ttp, tte, tc.moe, tx.dtype)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)
    if cf == 0.5:  # the capacity really dropped choices
        full = tmoe._dispatch_grouped(
            tp, tx, ttp, tte, dataclasses.replace(tc.moe, capacity_factor=8),
            tx.dtype)
        assert not torch.equal(full, got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_dispatch_matches_reference(dtype):
    """dispatch='ragged': expert segments in sorted order, no drops."""
    jc, tc = _cfgs("granite_moe_1b", dispatch="ragged")
    jp, tp = _params(jc, 2)
    x = np.random.default_rng(3).standard_normal((2, 9, jc.d_model)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    with jax.disable_jit():
        want, _ = jmoe.moe_apply(jp, jx, jc)
    got, _ = tmoe.moe_apply(tp, tx, tc)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# The CIM path: the dense loop over every expert through the macro
# ---------------------------------------------------------------------------


def _record(monkeypatch, module, calls):
    real = module.execute

    def rec(x, plan, policy, **kw):
        y = real(x, plan, policy, **kw)
        calls.append((x, plan, y))
        return y

    monkeypatch.setattr(module, "execute", rec)
    return real


@pytest.mark.parametrize("mode", ["cim-exact", "cim", "cim-kernel"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dense_cim_loop_and_planned_expert_view(arch, mode, monkeypatch):
    """Under every CIM mode the port serves a planned bank ([E, K, N]
    codes) and reads expert e as a view; the reference, which cannot index
    its planned bank, plans the expert's [K, N] slice per call
    (``engine.matmul``). Each of the 3 x E macro calls (and the shared
    expert's 3) gets the same plan (codes, scales, colsums) and gives the
    reference's output bit for bit on the reference's input; the block's
    output is the reference's bit for bit in bfloat16. The port's
    cim-kernel (on the CPU: B1's plain version) is held to the
    reference's cim."""
    jc, tc = _cfgs(arch)
    jc = jc.replace(cim=JPolicy(mode="cim" if mode == "cim-kernel"
                                else mode, cim=JOP))
    tc = tc.replace(cim=TPolicy(mode=mode, cim=TOP))
    jp, tp = _params(jc, 3)
    tplan = tengine.plan_params(tp, policy=tc.cim)
    assert isinstance(tplan["gate"], tengine.PlannedWeights)
    assert tplan["gate"].codes.shape == (tc.moe.n_experts, tc.d_model,
                                         tc.moe.d_expert)
    x = np.random.default_rng(4).standard_normal((2, 4, jc.d_model)).astype(
        np.float32)
    jx, tx = _pair(x, "bfloat16")
    jcalls, tcalls = [], []
    _record(monkeypatch, jengine, jcalls)
    execute = _record(monkeypatch, tengine, tcalls)
    with jax.disable_jit():
        want, jm = jmoe.moe_apply(jp, jx, jc, policy=jc.cim)
    with torch.no_grad():
        got, tm = tmoe.moe_apply(tplan, tx, tc, policy=tc.cim)
    n_calls = 3 * tc.moe.n_experts + (3 if tc.moe.d_shared else 0)
    assert len(jcalls) == len(tcalls) == n_calls
    for i, ((jx_, jplan, jy), (_, tpl, _)) in enumerate(
            zip(jcalls, tcalls, strict=True)):
        for f in ("codes", "scale", "colsum"):
            np.testing.assert_array_equal(
                _np(getattr(tpl, f)), _np(getattr(jplan, f)),
                err_msg=f"call {i} {f}")
        y = execute(torch.from_numpy(np.array(jx_.astype(jnp.float32))).to(
            torch.bfloat16), tpl, tc.cim)
        np.testing.assert_array_equal(_np(y), _np(jy), err_msg=f"call {i}")
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_allclose(float(tm.aux_loss), float(jm.aux_loss),
                               rtol=1e-6)
    # The view shares the bank's storage.
    view = tmoe.expert(tplan["down"], 2)
    assert view.codes.data_ptr() == tplan["down"].codes[2].data_ptr()


# ---------------------------------------------------------------------------
# The shared expert and moe_apply on the SMOKE configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_shared_expert_and_its_gate(dtype):
    """qwen2-moe's shared SwiGLU (5632 wide in CONFIG) with its sigmoid
    gate: the block minus its routed part is gate * shared."""
    jc, tc = _cfgs("qwen2_moe_a2_7b")
    jp, tp = _params(jc, 5)
    assert tp["shared_gate"]["w"].shape == (tc.d_model, 1)
    assert tp["shared"]["up"]["w"].shape == (tc.d_model, tc.moe.d_shared)
    x = np.random.default_rng(5).standard_normal((12, jc.d_model)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    with jax.disable_jit():
        jsh = jcommon.mlp_apply(jp["shared"], jx, "silu", None)
        jg = jax.nn.sigmoid(jx @ jp["shared_gate"]["w"].astype(jx.dtype))
    tsh = tcommon.mlp_apply(tp["shared"], tx, "silu", None)
    tg = tcommon._sigmoid(tx @ tp["shared_gate"]["w"].to(tx.dtype))
    _close(tsh, jsh, dtype)
    _close(tg, jg, dtype)
    no_shared = tc.replace(moe=dataclasses.replace(tc.moe, d_shared=0))
    with torch.no_grad():
        full, _ = tmoe.moe_apply(tp, tx[None], tc)
        routed, _ = tmoe.moe_apply({k: v for k, v in tp.items()
                                    if not k.startswith("shared")},
                                   tx[None], no_shared)
    _close(full[0], routed[0] + tg * tsh, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_smoke_matches_reference(arch, dtype):
    """The SMOKE block, digital (grouped dispatch), on the reference's
    params: output and aux/entropy."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, 6)
    spec = {k: tuple(v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(jmoe.moe_spec(jc),
                                                is_leaf=lambda s: hasattr(
                                                    s, "axes"))}
    tspec = {k: tuple(v.shape) for k, v in
             jax.tree_util.tree_leaves_with_path(tmoe.moe_spec(tc),
                                                 is_leaf=lambda s: hasattr(
                                                     s, "axes"))}
    assert tspec == spec
    x = np.random.default_rng(7).standard_normal((2, 6, jc.d_model)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    with jax.disable_jit():
        want, jm = jmoe.moe_apply(jp, jx, jc)
    got, tm = tmoe.moe_apply(tp, tx, tc)
    assert got.shape == (2, 6, tc.d_model) and got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)
    for a, b in zip(tm, jm, strict=True):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
