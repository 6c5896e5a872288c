"""The macro call's periphery as kernels (``kernels/periphery.py``,
``csrc/periphery.cu``).

On the CPU: the plain versions against what the engine runs everywhere
else, bit for bit: ``quantize_acts_plain`` against ``quant.quantize_acts``
(float32, bfloat16, float16; symmetric and asymmetric; clip 1.0 and
0.995; M from 1 to 4096; constant tensors, zeros, tiny ranges, NaN and
x / scale ties) and, through ``engine.execute`` with the path forced on,
``dequant_epilogue_plain`` against the engine's ATen epilogue; the path
rule (never on the CPU, under autograd through the scales, for other
dtypes); the launches a quantizer call makes on each side of
``SINGLE_BLOCK_MAX`` (the C entry points replaced by a recorder).

Marked ``card`` (skipped without a CUDA device; run on the card with
``PYTHONPATH=src python -m pytest --noconftest -q
tests/test_torch_periphery.py``, since ``tests/conftest.py`` imports JAX):
each kernel against its plain version and against the ATen ops on the
card, bit for bit, at the granite expert and qwen2 prefill shapes and on
both sides of the single-block threshold; ``build.stream`` against
``torch.cuda.current_stream`` on the default stream, a side stream and in
a graph's capture; a 2-layer qwen2-shaped engine's
graphed ``generate`` against its eager one with the kernels captured; a
2-layer granite engine's tokens and prefill logits against the same
engine with the kernels forced off.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import CIMPolicy, get_config
from repro_torch.core import engine, quant
from repro_torch.core.params import PAPER_OP_16ROWS
from repro_torch.kernels import build, cim_mac, periphery
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DT_IDS = ("f32", "bf16", "f16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _acts(m, k, dtype, symmetric, seed, device="cpu"):
    """[m, k] activations: post-ReLU for the symmetric quantizer, signed
    with an offset otherwise."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=gen) * 3.0
    x = x.abs() if symmetric else x + 0.7
    return x.to(dtype).to(device)


def _same_qa(got, want):
    assert got.codes.dtype == want.codes.dtype == torch.int32
    assert got.scale.dtype == want.scale.dtype
    assert got.scale.shape == want.scale.shape == (1, 1)
    assert got.zero_point.dtype == want.zero_point.dtype == torch.int32
    assert got.zero_point.shape == want.zero_point.shape
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.zero_point, want.zero_point)
    if want.scale.isnan().all():
        assert got.scale.isnan().all()
    else:
        assert torch.equal(got.scale, want.scale)


# Edge tensors: constants (hi = lo, the ``lo + eps`` branch), zeros, a range
# below eps, NaN, and x / scale ties (range [0, 15] or [-7.5, 7.5] gives
# scale 1 at act_bits 4, so halves tie; the zero point 7.5 ties too).
EDGES = {
    "zeros": lambda: torch.zeros(3, 8),
    "const-pos": lambda: torch.full((3, 8), 1.75),
    "const-neg": lambda: torch.full((3, 8), -3.5),
    "const-tiny": lambda: torch.full((3, 8), -9.9e-9),
    "tiny-range": lambda: torch.tensor([[-1.0e-8, 3e-9, 0.0, -2e-9]]),
    "ties-pos": lambda: torch.tensor([[0.0, 0.5, 1.5, 2.5, 3.5, 14.5, 15.0,
                                       7.5]]),
    "ties-signed": lambda: torch.tensor([[-7.5, -6.5, -0.5, 0.5, 1.5, 6.5,
                                          7.5, 2.5]]),
    "nan": lambda: torch.tensor([[1.0, float("nan"), -2.0, 0.5]]),
}


# ---------------------------------------------------------------------------
# The plain versions on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 5, 64, 4096])
@pytest.mark.parametrize("clip", [1.0, 0.995], ids=["clip1", "clip0995"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_quantizer_plain_equals_quantize_acts(dtype, symmetric, clip, m):
    x = _acts(m, 40, dtype, symmetric, seed=m)
    want = quant.quantize_acts(x, 4, symmetric=symmetric, clip_pct=clip)
    _same_qa(periphery.quantize_acts_plain(x, 4, symmetric=symmetric,
                                           clip_pct=clip), want)
    # The wrapper runs the plain version on CPU tensors.
    _same_qa(periphery.quantize_acts(x, 4, symmetric=symmetric,
                                     clip_pct=clip), want)


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("edge", list(EDGES))
def test_quantizer_plain_edges(edge, dtype, symmetric):
    x = EDGES[edge]().to(dtype)
    for bits in (4, 8):
        _same_qa(periphery.quantize_acts_plain(x, bits, symmetric=symmetric),
                 quant.quantize_acts(x, bits, symmetric=symmetric))


def test_ties_round_half_to_even():
    x = EDGES["ties-pos"]()
    qa = periphery.quantize_acts_plain(x, 4, symmetric=True)
    assert qa.scale.item() == 1.0
    assert qa.codes.tolist() == [[0, 0, 2, 2, 4, 14, 15, 8]]
    qa = periphery.quantize_acts_plain(EDGES["ties-signed"](), 4)
    assert qa.zero_point.item() == 8  # round(7.5) to even
    assert qa.codes.tolist() == [[0, 2, 8, 8, 10, 14, 15, 10]]


def _plan(k, n, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    w = (torch.randn((k, n), generator=gen) * 0.05).to(dtype)
    return engine.plan_weights(w, PAPER_OP_16ROWS, with_planes=False)


def _policy(mode, symmetric, clip):
    return CIMPolicy(mode=mode, cim=PAPER_OP_16ROWS, act_symmetric=symmetric,
                     act_clip_pct=clip)


@pytest.mark.parametrize("mode", ["cim-exact", "fp-cast"])
@pytest.mark.parametrize("clip", [1.0, 0.995], ids=["clip1", "clip0995"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_forced_path_equals_aten_through_the_engine(dtype, symmetric, clip,
                                                    mode, monkeypatch):
    """The engine with ``takes`` forced on (the wrappers run the plain
    versions on the CPU) against its ATen path, output for output. Under
    'fp' mode the epilogue keeps float32 (the exact backend under a
    policy whose mode is 'fp')."""
    x = _acts(37, 96, dtype, symmetric, seed=3)
    plan = _plan(96, 24, seed=4)
    pol = _policy("cim-exact", symmetric, clip)
    if mode == "fp-cast":
        pol = dataclasses.replace(pol, mode="fp", backend="exact")
    run = engine.get_backend("exact")
    want = run(x, plan, pol, None)
    calls = []
    for name in ("quantize_acts", "dequant_epilogue"):
        fn = getattr(periphery, name)
        monkeypatch.setattr(periphery, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    monkeypatch.setattr(periphery, "takes", lambda x2, plan: True)
    got = run(x, plan, pol, None)
    assert calls == ["quantize_acts", "dequant_epilogue"]
    assert got.dtype == want.dtype == (torch.float32 if mode == "fp-cast"
                                       else dtype)
    assert torch.equal(got, want)


def test_epilogue_plain_with_minimal_plan(monkeypatch):
    """A plan without colsum: the engine recovers it, then the epilogue."""
    x = _acts(6, 48, torch.bfloat16, False, seed=5)
    plan = dataclasses.replace(_plan(48, 12, seed=6), colsum=None)
    pol = _policy("cim-exact", False, 1.0)
    want = engine.execute(x, plan, pol)
    monkeypatch.setattr(periphery, "takes", lambda x2, plan: True)
    assert torch.equal(engine.execute(x, plan, pol), want)


# ---------------------------------------------------------------------------
# The path rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64,
                                   torch.int32, torch.int8])
def test_path_rule(dtype, monkeypatch):
    plan = _plan(8, 4, seed=0)
    x = torch.ones((3, 8), dtype=dtype)
    assert not periphery.takes(x, plan)  # never on the CPU
    monkeypatch.setattr(periphery, "_on_card", lambda t: True)
    float_kernel = dtype in (torch.float32, torch.bfloat16, torch.float16)
    assert periphery.takes(x, plan) == float_kernel
    assert not periphery.takes(x[:0], plan)
    if not float_kernel or dtype == torch.float64:
        return
    xg = x.clone().requires_grad_(True)
    assert not periphery.takes(xg, plan)
    sg = dataclasses.replace(plan, scale=plan.scale.clone().requires_grad_())
    assert not periphery.takes(x, sg)
    with torch.no_grad():
        assert periphery.takes(xg, plan) and periphery.takes(x, sg)


def test_cpu_engine_and_autograd_keep_the_aten_ops(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the fused periphery ran")

    monkeypatch.setattr(periphery, "quantize_acts", refuse)
    monkeypatch.setattr(periphery, "dequant_epilogue", refuse)
    x = _acts(4, 32, torch.bfloat16, False, seed=1)
    plan = _plan(32, 8, seed=2)
    for mode in ("cim-exact", "cim", "cim-kernel"):
        engine.execute(x, plan, _policy(mode, False, 1.0))
    # On a card, autograd through the scales (matmul without ste) keeps
    # the ATen ops; STE's forward records nothing and takes the kernels.
    monkeypatch.setattr(periphery, "_on_card", lambda t: True)
    pol = dataclasses.replace(_policy("cim-exact", False, 1.0), ste=False)
    w = torch.randn((32, 8), requires_grad=True)
    engine.matmul(x.float().requires_grad_(), w, pol).sum().backward()
    assert w.grad is not None


# ---------------------------------------------------------------------------
# The launches, with the C entry points recorded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, 0.995], ids=["clip1", "clip0995"])
@pytest.mark.parametrize("over", [0, 4], ids=["at-threshold", "above"])
def test_quantizer_launches(over, clip, monkeypatch):
    n = periphery.SINGLE_BLOCK_MAX + over
    x = torch.ones((n // 4, 4), dtype=torch.bfloat16)
    made = []

    def record(source, kernel, *args):
        assert source == periphery.SOURCE
        made.append((kernel, args))
        cim_mac.LAUNCHES[kernel] += 1

    monkeypatch.setattr(periphery, "_on_card", lambda t: True)
    monkeypatch.setattr(build, "launch", record)
    monkeypatch.setattr(build, "stream", lambda t: 0)
    before = cim_mac.LAUNCHES.copy()
    periphery.quantize_acts(x, 4, clip_pct=clip)
    kernels = [k for k, _ in made]
    blocks = periphery.grid(-(-n // 4))
    if clip < 1.0:  # the percentile's range: one launch over the grid
        assert kernels == ["act_quant"]
        assert made[0][1][3:5] == (blocks, 2)
    elif not over:  # one block ranges and codes
        assert kernels == ["act_quant"]
        assert made[0][1][3:5] == (1, 0)
    else:  # partial ranges, then every block reduces them
        assert kernels == ["act_range", "act_quant"]
        assert made[0][1][2:4] == (n, blocks)
        assert made[1][1][3:7] == (blocks, 1, made[0][1][4], blocks)
    assert cim_mac.LAUNCHES - before == {k: kernels.count(k)
                                         for k in kernels}


def test_grid():
    assert periphery.grid(1) == 1
    assert periphery.grid(periphery.THREADS) == 1
    assert periphery.grid(periphery.THREADS + 1) == 2
    assert periphery.grid(1 << 30) == periphery.MAX_BLOCKS


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        periphery.quantize_acts(torch.ones((2, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        periphery.quantize_acts(torch.ones((2, 3, 4)), 4)
    qa = periphery.quantize_acts(torch.ones((2, 3)), 4)
    y = torch.ones((2, 5))
    ones = torch.ones((1, 5))
    with pytest.raises(TypeError):
        periphery.dequant_epilogue(y.double(), qa, ones, ones, torch.float32)
    with pytest.raises(TypeError):
        periphery.dequant_epilogue(y, qa, ones, ones, torch.bfloat16)
    with pytest.raises(ValueError):
        periphery.dequant_epilogue(y, qa, torch.ones((1, 4)), ones,
                                   torch.float32)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (M, K): a granite expert (M = 1-4 tokens, K = 1024 in, 512 out), a qwen2
# decode step's down projection, the qwen2 prefill's projections (M = 4096,
# K = 896 and 4864), a ragged tail (K not a multiple of 4); the test adds
# the single-block threshold's last shape and the next.
CARD_SHAPES = [(1, 1024), (4, 1024), (4, 512), (4, 4864), (4096, 896),
               (4096, 4864), (3, 7)]


@pytest.mark.card
@pytest.mark.parametrize("clip", [1.0, 0.995], ids=["clip1", "clip0995"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_quantizer_kernel_equals_plain(card, dtype, symmetric, clip):
    last = periphery.SINGLE_BLOCK_MAX // 64
    for i, (m, k) in enumerate(CARD_SHAPES + [(last, 64), (last + 1, 64)]):
        x = _acts(m, k, dtype, symmetric, seed=10 + i, device=card)
        got = periphery.quantize_acts(x, 4, symmetric=symmetric,
                                      clip_pct=clip)
        _same_qa(got, periphery.quantize_acts_plain(
            x, 4, symmetric=symmetric, clip_pct=clip))
        _same_qa(got, quant.quantize_acts(x, 4, symmetric=symmetric,
                                          clip_pct=clip))
    # An activation one element off its allocation's alignment (the
    # kernels' scalar loads).
    buf = _acts(1, 4 * 1024 + 1, dtype, symmetric, seed=9, device=card)
    x = buf[0, 1:].view(4, 1024)
    _same_qa(periphery.quantize_acts(x, 4, symmetric=symmetric,
                                     clip_pct=clip),
             quant.quantize_acts(x, 4, symmetric=symmetric, clip_pct=clip))
    torch.cuda.synchronize()


@pytest.mark.card
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_quantizer_kernel_edges(card, dtype, symmetric):
    for edge, bits in itertools.product(EDGES, (4, 8)):
        x = EDGES[edge]().to(dtype).to(card)
        got = periphery.quantize_acts(x, bits, symmetric=symmetric)
        _same_qa(got, quant.quantize_acts(x, bits, symmetric=symmetric))
        _same_qa(got, periphery.quantize_acts_plain(x, bits,
                                                    symmetric=symmetric))
        # Above the threshold, the two-pass form over the same values.
        reps = -(-(periphery.SINGLE_BLOCK_MAX + 1) // x.numel())
        xl = x.repeat(reps, 1)
        _same_qa(periphery.quantize_acts(xl, bits, symmetric=symmetric),
                 quant.quantize_acts(xl, bits, symmetric=symmetric))


# (M, K, N): granite expert up/gate and down, a qwen2 decode projection,
# the prefill's q and down projections, N not a multiple of 4.
EPI_SHAPES = [(4, 1024, 512), (1, 512, 1024), (4, 896, 4864),
              (4096, 896, 896), (4096, 4864, 896), (5, 16, 10)]


@pytest.mark.card
@pytest.mark.parametrize("fp_out", [False, True], ids=["cast", "f32"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_epilogue_kernel_equals_plain(card, dtype, fp_out, monkeypatch):
    out_dtype = torch.float32 if fp_out else dtype
    for i, (m, k, n) in enumerate(EPI_SHAPES):
        x = _acts(m, k, dtype, False, seed=20 + i, device=card)
        plan = _plan(k, n, seed=30 + i)
        plan = dataclasses.replace(plan, codes=plan.codes.to(card),
                                   scale=plan.scale.to(card),
                                   colsum=plan.colsum.to(card))
        qa = quant.quantize_acts(x, 4)
        y_int = cim_mac.gpq_matmul(qa.codes, plan.codes, PAPER_OP_16ROWS)
        got = periphery.dequant_epilogue(y_int, qa, plan.colsum, plan.scale,
                                         out_dtype)
        want = periphery.dequant_epilogue_plain(y_int, qa, plan.colsum,
                                                plan.scale, out_dtype)
        assert got.dtype == want.dtype == out_dtype
        assert torch.equal(got, want)
        # The engine's ATen epilogue on the same macro output.
        aten = (y_int - qa.zero_point.to(torch.float32) * plan.colsum)
        assert torch.equal(got, (aten * qa.scale * plan.scale).to(out_dtype))
    torch.cuda.synchronize()


@pytest.mark.card
def test_launch_stream_is_the_current_stream(card):
    """``build.stream``, the handle every launch is enqueued on, is
    ``torch.cuda.current_stream``'s: on the default stream, under a side
    stream and inside a graph's capture."""
    t = torch.zeros(4, device=card)

    def current():
        return torch.cuda.current_stream(t.device).cuda_stream

    default = current()
    assert build.stream(t) == default
    side = torch.cuda.Stream(device=t.device)
    with torch.cuda.stream(side):
        assert build.stream(t) == current() == side.cuda_stream != default
    assert build.stream(t) == default
    graph, seen = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        seen.append((build.stream(t), current()))
        t.add_(1)
    assert seen[0][0] == seen[0][1] != default
    graph.replay()
    torch.cuda.synchronize()
    assert t.tolist() == [1.0] * 4


def _kernel_cfg(arch, **kw):
    return get_config(arch, smoke=True).replace(
        cim=CIMPolicy(mode="cim-kernel", cim=PAPER_OP_16ROWS), **kw)


def _prompts(cfg, batch, length, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, length), generator=gen)


@pytest.mark.card
def test_graphed_generate_captures_the_kernels(card):
    cfg = _kernel_cfg("qwen2_0_5b")
    params = transformer.init(0, cfg, device=card)
    graphed = ServeEngine(params, cfg, max_len=24, batch=4, plan=True)
    eager = ServeEngine(params, cfg, max_len=24, batch=4, plan=True)
    eager.decode_graph = None
    prompts = _prompts(cfg, 4, 8, 0)
    before = cim_mac.LAUNCHES.copy()
    got = graphed.generate(prompts, 8)
    launched = cim_mac.LAUNCHES - before
    per_step = cfg.n_layers * 7
    # The prefill's calls, the first step's eager run and its capture, each
    # through the kernels; the replays call no wrapper.
    assert launched["act_quant"] == launched["dequant_epilogue"] \
        == launched["gpq_matmul"] == 3 * per_step
    np.testing.assert_array_equal(got, eager.generate(prompts, 8))
    np.testing.assert_array_equal(graphed.generate(prompts, 8), got)


def _granite_engine(card):
    cfg = _kernel_cfg("granite_moe_1b", n_layers=2)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="ragged"))
    params = transformer.init(0, cfg, device=card)
    return cfg, ServeEngine(params, cfg, max_len=24, batch=4, plan=True)


@pytest.mark.card
def test_granite_tokens_equal_with_the_kernels_off(card, monkeypatch):
    cfg, eng = _granite_engine(card)
    prompts = _prompts(cfg, 4, 8, 1)
    before = cim_mac.LAUNCHES.copy()
    with torch.no_grad():
        fused = eng.generate(prompts, 6)
        caches = transformer.init_caches(cfg, 4, 24, device=card)
        logits, _ = transformer.prefill(eng.params, prompts.to(card), caches,
                                        cfg)
    launched = cim_mac.LAUNCHES - before
    assert launched["act_quant"] == launched["dequant_epilogue"] \
        == launched["gpq_matmul"] > 0
    monkeypatch.setattr(periphery, "takes", lambda x2, plan: False)
    before = cim_mac.LAUNCHES.copy()
    with torch.no_grad():
        aten = eng.generate(prompts, 6)
        caches = transformer.init_caches(cfg, 4, 24, device=card)
        aten_logits, _ = transformer.prefill(eng.params, prompts.to(card),
                                             caches, cfg)
    assert set(cim_mac.LAUNCHES - before) == {"gpq_matmul"}
    np.testing.assert_array_equal(fused, aten)
    assert torch.equal(logits, aten_logits)
