"""repro_torch's serving path (ServeEngine, ContinuousBatcher, int8
weight-only plans, the one-shot matmul, the CLI) against the JAX
reference on the CPU, qwen2 SMOKE with the reference's own parameters
carried across.

The reference's ServeEngine jits its steps; inside jit XLA fuses the
bfloat16 ops and keeps float32 between them, which moves activation
codes and greedy tokens (its jitted and eager engines disagree on this
file's prompts). The port follows the eager per-op rounding, so the
reference engines run under ``jax.disable_jit`` and the greedy tokens
must be equal. The one-shot matmul and the int8 plans are bit-exact.
"""

import dataclasses
import sys

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
from repro.serve import engine as jserve
from repro.serve import quantized as jquantized
from repro_torch import convert
from repro_torch.configs.base import CIMPolicy as TPolicy
from repro_torch.configs.base import get_config as tget
from repro_torch.core import engine as tengine
from repro_torch.core.params import PAPER_OP_16ROWS as TOP
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.serve import engine as tserve
from repro_torch.serve import quantized as tquantized

# examples/serve_cim.py's schedule: five (prompt length, max_new) requests
# sharing two decode slots.
SCHEDULE = [(4, 6), (8, 4), (3, 8), (6, 5), (5, 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jt.init(jax.random.PRNGKey(0), jget("qwen2_0_5b", smoke=True))
    return jp, convert.to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _cfgs(mode):
    jc, tc = jget("qwen2_0_5b", smoke=True), tget("qwen2_0_5b", smoke=True)
    if mode == "fp":
        return jc, tc
    return (jc.replace(cim=JPolicy(mode=mode, cim=JOP)),
            tc.replace(cim=TPolicy(mode=mode, cim=TOP)))


@pytest.mark.parametrize("plan", [False, True], ids=["unplanned", "planned"])
@pytest.mark.parametrize("mode", ["fp", "cim-exact"])
def test_generate_tokens_equal_reference(params, mode, plan):
    """Batch 2, 8-token prompts, 6 greedy tokens; bfloat16 activations (the
    config's). Planned under fp is int8 weight-only serving; unplanned
    under cim-exact plans every matmul per call (engine.matmul)."""
    jc, tc = _cfgs(mode)
    prompts = np.random.default_rng(1).integers(0, 512, (2, 8))
    with jax.disable_jit():
        jeng = jserve.ServeEngine(params[0], jc, max_len=32, batch=2,
                                  plan=plan)
        want = jeng.generate(jnp.asarray(prompts, jnp.int32), 6)
    teng = tserve.ServeEngine(params[1], tc, max_len=32, batch=2, plan=plan,
                              device="cpu")
    got = teng.generate(torch.from_numpy(prompts), 6)
    assert got.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if plan:
        wq = teng.params["units"]["layer_00"]["attn"]["wq"]["w"]
        assert isinstance(wq, tengine.PlannedWeights)
        assert (wq.w is None) == (mode == "fp")


def _batch(pkg, params, cfg, schedule, **kw):
    """examples/serve_cim.py's demo: planned, max_len 96, two slots."""
    eng = pkg.ServeEngine(params, cfg, max_len=96, batch=2, plan=True, **kw)
    batcher = pkg.ContinuousBatcher(eng, eos_token=-1)
    rng = np.random.default_rng(0)
    for rid, (plen, gen) in enumerate(schedule):
        batcher.submit(pkg.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new=gen))
    with jax.disable_jit(pkg is jserve):
        done = batcher.run_until_done()
    return {r.rid: r.generated for r in done}


@pytest.mark.parametrize("mode", ["fp", "cim-exact"])
def test_continuous_batcher_schedule_equals_reference(params, mode):
    """examples/serve_cim.py's five requests over two slots (planned, as
    the example plans): each request's tokens equal the reference's.

    The reference's slots perturb each other (every whole-batch decode
    step writes all slots' cache rows at one position), so request 0
    alone gives other tokens than beside requests 1 and 2; the port
    reproduces that stream too."""
    jc, tc = _cfgs(mode)
    want = _batch(jserve, params[0], jc, SCHEDULE)
    got = _batch(tserve, params[1], tc, SCHEDULE, device="cpu")
    assert sorted(got) == list(range(5))
    assert [len(got[r]) for r in range(5)] == [g for _, g in SCHEDULE]
    assert got == want
    if mode == "fp":
        alone = _batch(tserve, params[1], tc, SCHEDULE[:1], device="cpu")
        assert alone == _batch(jserve, params[0], jc, SCHEDULE[:1])
        assert alone[0] != got[0]


@pytest.mark.parametrize("mode", ["cim-exact", "cim", "cim-kernel"])
def test_one_shot_matmul_bit_exact_and_no_backward(mode):
    """engine.matmul (plan per call, then execute) equals the reference's
    forward bit for bit in float32. (Before training was ported its
    backward raised, hence the name.) Its backward is now the reference's
    straight-through one: the gradients equal jax.grad's to float32
    rounding, and a call under no_grad runs the same forward."""
    jpol = JPolicy(mode="cim" if mode == "cim-kernel" else mode, cim=JOP)
    tpol = TPolicy(mode=mode, cim=TOP)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    want = jengine.matmul(jnp.asarray(x), jnp.asarray(w), jpol)
    got = tengine.matmul(torch.from_numpy(x), torch.from_numpy(w), tpol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = rng.standard_normal((3, 5, 40)).astype(np.float32)
    jgw = jax.grad(lambda w_: jnp.vdot(jnp.asarray(g), jengine.matmul(
        jnp.asarray(x), w_, jpol)))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    y = tengine.matmul(torch.from_numpy(x), wt, tpol)
    (tgw,) = torch.autograd.grad(y, wt, torch.from_numpy(g))
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tengine.matmul(torch.from_numpy(x), wt, tpol).numpy(),
            got.numpy())


def test_int8_serving_plans_bit_exact(params):
    """quantize_params_for_serving: the same leaves become int8 plans with
    no float copy and no planes, codes and scales bit for bit; the read
    paths dequantize alike."""
    want = jquantized.quantize_params_for_serving(params[0])
    got = tquantized.quantize_params_for_serving(params[1])
    jw = want["units"]["layer_00"]["mlp"]["down"]["w"]
    tw = got["units"]["layer_00"]["mlp"]["down"]["w"]
    assert isinstance(tw, tengine.PlannedWeights)
    assert tw.w is None and tw.planes is None and tw.slots is None
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    for dt in (jnp.float32, jnp.bfloat16):
        td = getattr(torch, jnp.dtype(dt).name)
        np.testing.assert_array_equal(
            tquantized.dequantize_weight(tw, td).float().numpy(),
            np.asarray(jquantized.dequantize_weight(jw, dt), np.float32))
    assert torch.equal(tquantized.maybe_dequant(tw, torch.float32),
                       tw.dequantized())
    raw = params[1]["embed"]["table"]
    assert torch.equal(tquantized.maybe_dequant(raw, torch.float32), raw)
    assert got["embed"]["table"] is raw
    assert isinstance(got["units"]["layer_00"]["attn"]["wq"]["b"],
                      torch.Tensor)


def test_reference_caches_carry_across(params):
    """convert.to_torch takes the reference's caches tree (stacked
    bfloat16 KVCache named tuples) to the port's, value for value."""
    jc, tc = _cfgs("fp")
    jcache = jt.init_caches(jc, 2, 16, dtype=jnp.bfloat16)
    _, jcache = jax.jit(jt.prefill, static_argnums=(3,))(
        params[0], jnp.ones((2, 5), jnp.int32), jcache, jc)
    got = convert.to_torch(jcache, device="cpu")
    kv = got["units"]["layer_00"]
    assert isinstance(kv, tattn.KVCache) and kv.k.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        kv.v.float().numpy(),
        np.asarray(jcache["units"]["layer_00"].v, np.float32))


def test_serve_engine_registers_calibration(params):
    """ServeEngine(calibration=) registers a saved calibration result under
    the policy's backend name and plans with it. The ResNet result's
    layers match no LM shape, so every projection runs at the result's
    base operating point, the paper's: the tokens equal the plain cim
    engine's (held to the reference above)."""
    from repro_torch.core import calibrate as tcal

    name = "test-served-calibration"
    tc = tget("qwen2_0_5b", smoke=True)
    pol = TPolicy(mode="cim", cim=TOP)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(0, 512,
                                                                 (2, 4)))
    res = tcal.load_result("results/calibration/resnet_paper_p8t.json")
    # The noiseless transfer's parameters (the result was swept at 0.6 V).
    what = ("rows_active", "act_bits", "weight_bits", "threshold",
            "adc_step", "adc_codes", "adc_mode")
    assert [getattr(res.base, a) for a in what] == [getattr(TOP, a)
                                                   for a in what]
    try:
        with pytest.warns(UserWarning, match="no calibrated layer"):
            teng = tserve.ServeEngine(
                params[1], tc.replace(cim=dataclasses.replace(
                    pol, backend=name)), max_len=8, batch=2, plan=True,
                device="cpu", calibration=res)
            got = teng.generate(prompts, 3)
        assert name in tengine.backend_names()
    finally:  # the registry is process-wide
        tengine._BACKENDS.pop(name, None)
    want = tserve.ServeEngine(params[1], tc.replace(cim=pol), max_len=8,
                              batch=2, plan=True, device="cpu").generate(
                                  prompts, 3)
    np.testing.assert_array_equal(got, want)


def test_serve_engine_unported_options_raise(params):
    tc = tget("qwen2_0_5b", smoke=True)
    for kw in (dict(donate_plan=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tserve.ServeEngine(params[1], tc, max_len=8, batch=1,
                               device="cpu", **kw)
    # restore_planned is ported (tests/test_torch_checkpoint.py): a
    # directory without a checkpoint raises as the store's restore does
    with pytest.raises(FileNotFoundError, match="LATEST"):
        tserve.ServeEngine.restore_planned("x", tc, max_len=8, batch=1,
                                           device="cpu")
    eng = tserve.ServeEngine(params[1], tc, max_len=8, batch=2, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        eng.generate(torch.zeros((3, 2), dtype=torch.long), 2)
    assert dataclasses.is_dataclass(tserve.Request)


def test_serve_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2_0_5b", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "6", "--gen", "3",
        "--cim-mode", "cim-kernel"])
    tlaunch.main()
    out = capsys.readouterr().out
    assert "mode=cim-kernel on cpu: generated 6 tokens" in out
    assert out.strip().splitlines()[-1].startswith("sample: [")
