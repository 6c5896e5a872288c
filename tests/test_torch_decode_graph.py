"""One CUDA graph per decode step (``serve.engine.DecodeGraph``).

On the CPU: the decode step's device position (``attention.decode_step``
at a 0-d tensor ``pos``: the RoPE positions, the cache slot written by
``index_copy_`` and the attention mask) against the int position's slice
write, bit for bit, over the full cache, its clamp at ``c - 1`` and a
ring window before and after its wrap; the step reads no tensor on the
host; ``graphs_decode`` for every architecture.

Marked ``card`` (skipped without a CUDA device; run on the card with
``PYTHONPATH=src python -m pytest --noconftest -q
tests/test_torch_decode_graph.py``, since ``tests/conftest.py`` imports
JAX): a 2-layer qwen2-shaped model (GQA, QKV bias, tied head) under
cim-kernel, the graphed engine against the same engine stepping eagerly:
``generate``'s tokens and the caches over two prompt batches on one
captured graph, the continuous batcher's schedule, and per ``generate``
the spans, the dispatch resolutions reported and the B1 kernels the
card ran, counted in a device trace (168 a step at 24 layers), while
``cim_mac.LAUNCHES`` counts only the wrappers' launches on the host (a
replay calls none); an engine of MoE or encoder-decoder layers captures
nothing.
"""

import collections
import contextlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, CIMPolicy, get_config
from repro_torch.core import engine
from repro_torch.core.params import PAPER_OP_16ROWS
from repro_torch.kernels import cim_mac, dispatch, periphery
from repro_torch.models import attention, common, transformer
from repro_torch.serve.engine import (ContinuousBatcher, Request,
                                      ServeEngine, graphs_decode)

P = "repro_torch."
# B1 as a device trace names it (perfbench's macro_roofline reads the same).
B1_KERNEL = re.compile(r"plane_mma_kernel.*BitPlanes.*Flash")
# examples/serve_cim.py's schedule: five (prompt length, max_new) requests
# sharing two decode slots.
SCHEDULE = [(4, 6), (8, 4), (3, 8), (6, 5), (5, 7)]


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


def _kernel_cfg(arch="qwen2_0_5b", **kw):
    return get_config(arch, smoke=True).replace(
        cim=CIMPolicy(mode="cim-kernel", cim=PAPER_OP_16ROWS), **kw)


# ---------------------------------------------------------------------------
# The device position, on the CPU
# ---------------------------------------------------------------------------


def _int_decode(params, x, cfg, cache, pos: int, window: int):
    """The decode step as it ran with a Python int position: slice writes
    at ``min(pos, c - 1)`` or ``pos % window``, the mask from the int."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32)
    q, k, v = attention._project_qkv(params, x, cfg, None)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    c = cache.k.shape[1]
    slots = torch.arange(c)
    if window and c == window:
        slot = pos % window
        valid = (slots < pos + 1) | (pos + 1 >= c)
    else:
        slot = min(pos, c - 1)
        valid = slots <= pos
    cache.k[:, slot] = attention.to_cache_dtype(k[:, 0], cache.k.dtype)
    cache.v[:, slot] = attention.to_cache_dtype(v[:, 0], cache.v.dtype)
    out = attention._gqa_core(q, cache.k, cache.v,
                              valid[None, None, None, None, :])
    return attention._out_proj(params, out, cfg, None), cache


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


# (window, max_len, pos, cache dtype): the full cache, its clamp past the
# last slot, a ring window before and after its wrap, a float8 cache.
POSITIONS = {
    "full": (0, 12, 5, torch.bfloat16),
    "clamp": (0, 12, 15, torch.bfloat16),
    "ring": (8, 32, 3, torch.bfloat16),
    "ring-wrapped": (8, 32, 13, torch.bfloat16),
    "fp8": (0, 12, 7, torch.float8_e4m3fn),
}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("case", list(POSITIONS))
def test_device_position_equals_the_int_slice_write(case, as_tensor):
    window, max_len, pos, dtype = POSITIONS[case]
    cfg = get_config("qwen2_0_5b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = common.init_params(gen, attention.attn_spec(cfg),
                                dtype=torch.bfloat16)
    x = torch.randn((3, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    want_cache = attention.init_cache(cfg, 3, max_len, window=window,
                                      dtype=dtype, device="cpu")
    for t in want_cache:  # rows the mask must keep out, or in
        t.copy_(torch.randn(t.shape, generator=gen).to(dtype))
    got_cache = attention.KVCache(*(t.clone() for t in want_cache))
    want, _ = _int_decode(params, x, cfg, want_cache, pos, window)
    got, same = attention.decode_step(
        params, x, cfg, got_cache, torch.tensor(pos) if as_tensor else pos,
        window=window)
    assert same is got_cache
    assert torch.equal(got, want)
    for g, w in zip(got_cache, want_cache, strict=True):
        assert torch.equal(_bits(g), _bits(w))


NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
         "__float__", "__index__")


@contextlib.contextmanager
def _host_reads(monkeypatch):
    """Count the tensor methods that read a value on the host (a sync on
    the card, refused inside a CUDA graph's capture)."""
    count = collections.Counter()

    def counted(name, fn):
        def read(self, *args, **kwargs):
            count[name] += 1
            return fn(self, *args, **kwargs)
        return read

    with monkeypatch.context() as m:
        for name in NAMES:
            m.setattr(torch.Tensor, name, counted(name,
                                                  getattr(torch.Tensor, name)))
        yield count


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma3_27b"])
def test_decode_step_reads_no_tensor_on_the_host(arch, monkeypatch):
    cfg = _kernel_cfg(arch)
    params = engine.plan_params(transformer.init(0, cfg, device="cpu"),
                                policy=cfg.cim)
    caches = transformer.init_caches(cfg, 2, 40, device="cpu")
    with torch.no_grad():
        transformer.prefill(params, torch.ones((2, 36), dtype=torch.long),
                            caches, cfg)
        with _host_reads(monkeypatch) as reads:
            logits, _ = transformer.decode_step(
                params, torch.ones(2, dtype=torch.long), torch.tensor(36),
                caches, cfg)
    assert logits.shape == (2, cfg.padded_vocab)
    assert not reads


# Which architectures' engines graph their decode steps on the card: the
# all-attention decoders with dense MLPs.
GRAPHED = {"qwen1_5_4b", "qwen2_0_5b", "yi_34b", "gemma3_27b",
           "internvl2_2b"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graphs_decode_by_architecture(arch):
    cfg = get_config(arch)
    assert graphs_decode(cfg, "cuda") == (arch in GRAPHED)
    assert not graphs_decode(cfg, "cpu")
    assert not graphs_decode(cfg.replace(cim=CIMPolicy(
        mode="cim", cim=PAPER_OP_16ROWS.replace(noisy=True))), "cuda")


def test_cpu_engine_steps_eagerly():
    cfg = _kernel_cfg()
    eng = ServeEngine(transformer.init(0, cfg, device="cpu"), cfg,
                      max_len=16, batch=2, plan=True, device="cpu")
    eng.generate(torch.ones((2, 4), dtype=torch.long), 3)
    assert eng.decode_graph is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _engines(cfg, batch, max_len):
    """The same planned model twice: graphed, and stepping eagerly."""
    params = transformer.init(0, cfg, device="cuda")
    graphed = ServeEngine(params, cfg, max_len=max_len, batch=batch,
                          plan=True)
    eager = ServeEngine(params, cfg, max_len=max_len, batch=batch, plan=True)
    eager.decode_graph = None
    assert graphed.decode_graph is not None
    return graphed, eager


def _prompts(cfg, batch, length, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, length), generator=gen)


@pytest.mark.card
def test_graphed_generate_equals_eager(card):
    cfg = _kernel_cfg()
    graphed, eager = _engines(cfg, batch=4, max_len=24)
    for seed, length in ((0, 8), (1, 12)):
        prompts = _prompts(cfg, 4, length, seed)
        got = graphed.generate(prompts, 8)
        captured = graphed.decode_graph.graph
        want = eager.generate(prompts, 8)
        np.testing.assert_array_equal(got, want)
        for g, w in zip(
                graphed.caches["units"]["layer_00"],
                eager.caches["units"]["layer_00"], strict=True):
            assert torch.equal(g, w)
    assert graphed.decode_graph.graph is captured  # one capture serves both


@pytest.mark.card
def test_continuous_batcher_through_the_graph(card):
    cfg = _kernel_cfg()
    done = {}
    for name, eng in zip(("graphed", "eager"), _engines(cfg, 2, 96),
                         strict=True):
        batcher = ContinuousBatcher(eng, eos_token=-1)
        rng = np.random.default_rng(0)
        for rid, (plen, gen) in enumerate(SCHEDULE):
            batcher.submit(Request(rid=rid, prompt=rng.integers(
                0, cfg.vocab_size, plen), max_new=gen))
        done[name] = {r.rid: r.generated for r in batcher.run_until_done()}
    assert done["graphed"] == done["eager"]
    assert [len(done["graphed"][i]) for i in range(5)] == [
        g for _, g in SCHEDULE]


def _counted_generate(eng, prompts, n):
    """One ``generate`` under the profiler: its span names, the dispatch
    resolutions reported, the B1 kernels in the device trace and the
    launches the wrappers counted on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = collections.Counter(cim_mac.LAUNCHES)
    torch.cuda.synchronize()
    with dispatch.record_resolutions() as log, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, n)
        torch.cuda.synchronize()
    raw = prof.profiler.kineto_results.events()
    traced = sum(ev.device_type() == DeviceType.CUDA
                 and B1_KERNEL.search(ev.name()) is not None for ev in raw)
    events = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in raw if ev.name().startswith(P + "serve.")]
    steps = [(s, e) for s, e, name in events
             if name == P + "serve.decode_step"]
    for s, e, name in events:  # a replay runs inside its decode step
        if name == P + "serve.decode_graph":
            assert any(a <= s and e <= b for a, b in steps)
    spans = collections.Counter(name for _, _, name in events)
    resolved = collections.Counter(
        (r.key.variant, r.key.backend, r.source) for r in log)
    return spans, resolved, traced, cim_mac.LAUNCHES - before


@pytest.mark.card
@pytest.mark.parametrize("n_layers", [2, 24])
def test_replays_report_every_macro_call(card, n_layers):
    cfg = _kernel_cfg(n_layers=n_layers)
    per_step = n_layers * 7
    n = 5
    prompts = _prompts(cfg, 4, 8, 0)
    counts = {}
    for name, eng in zip(("graphed", "eager"), _engines(cfg, 4, 16),
                         strict=True):
        eng.generate(prompts, 2)  # the graphed engine captures here
        counts[name] = _counted_generate(eng, prompts, n)
    g_spans, g_res, g_traced, g_launch = counts["graphed"]
    e_spans, e_res, e_traced, e_launch = counts["eager"]
    assert g_spans[P + "serve.decode_step"] == n - 1
    assert g_spans[P + "serve.decode_graph"] == n - 1
    assert g_spans[P + "serve.decode_capture"] == 0
    assert e_spans[P + "serve.decode_step"] == n - 1
    assert e_spans[P + "serve.decode_graph"] == 0
    assert g_res == e_res == {("p8t", "cuda", "explicit"): per_step * n}
    # The card ran every macro call, the prefill's and each replay's, as
    # the eager engine's trace counts them.
    assert g_traced == e_traced == per_step * n
    # On the host only the prefill's wrappers launched; a replay calls none.
    # Each macro call's periphery runs as act_quant and dequant_epilogue,
    # with act_range first where the activation passes the single block.
    ranged = (_two_pass(cfg, 4 * 8) + (n - 1) * _two_pass(cfg, 4)) * n_layers
    assert e_launch == _launches(per_step * n, ranged)
    assert g_launch == _launches(per_step, _two_pass(cfg, 4 * 8) * n_layers)


def _two_pass(cfg, m: int) -> int:
    """A layer's projections whose quantizer takes two launches (act_range,
    then act_quant) at m activation rows: those over SINGLE_BLOCK_MAX
    elements."""
    ks = (cfg.d_model,) * 5 + (cfg.n_heads * cfg.head_dim, cfg.d_ff)
    return sum(m * k > periphery.SINGLE_BLOCK_MAX for k in ks)


def _launches(calls: int, ranged: int) -> collections.Counter:
    return collections.Counter({"gpq_matmul": calls, "act_quant": calls,
                                "dequant_epilogue": calls,
                                "act_range": ranged})


@pytest.mark.card
@pytest.mark.parametrize("arch", ["granite_moe_1b", "whisper_tiny"])
def test_ineligible_engine_captures_nothing(card, arch):
    cfg = _kernel_cfg(arch)
    eng = ServeEngine(transformer.init(0, cfg, device="cuda"), cfg,
                      max_len=16, batch=2, plan=True)
    assert eng.decode_graph is None
    spans, _, _, _ = _counted_generate(eng, _prompts(cfg, 2, 4, 0), 4)
    assert spans[P + "serve.decode_step"] == 3
    assert not spans[P + "serve.decode_graph"] + spans[
        P + "serve.decode_capture"]
