"""repro_torch.tracing: the program's spans, on the CPU.

With no profiler active a span is one shared no-op and no record
function is made on any path; under ``torch.profiler.profile`` a small
``ServeEngine.generate`` and a small planned ``resnet.forward`` emit the
spans of ``tracing``'s table, nested as it says, with one quantize, one
macro and one epilogue span for each macro call that dispatch records.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import resnet as rcfg
from repro_torch.configs.base import CIMPolicy, get_config
from repro_torch.core import engine
from repro_torch.core.params import PAPER_OP_16ROWS
from repro_torch.kernels import dispatch
from repro_torch.models import resnet, transformer
from repro_torch.serve import engine as serve

P = "repro_torch."
ENGINE = {P + "engine.quantize", P + "engine.macro", P + "engine.epilogue"}
LM_SPANS = {P + "serve.generate", P + "serve.prefill",
            P + "serve.decode_step"} | ENGINE
RESNET_SPANS = {P + "resnet.forward", P + "resnet.im2col"} | ENGINE
N_TOKENS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server():
    cfg = get_config("qwen2_0_5b", smoke=True).replace(
        cim=CIMPolicy(mode="cim", cim=PAPER_OP_16ROWS))
    params = transformer.init(0, cfg, device="cpu")
    return serve.ServeEngine(params, cfg, max_len=16, batch=2, plan=True,
                             device="cpu")


def _prompts():
    return torch.randint(0, 512, (2, 6),
                         generator=torch.Generator().manual_seed(1))


def _resnet():
    cfg = rcfg.ResNetConfig(widths=(4, 8), blocks_per_stage=1,
                            cim=rcfg.cim_policy(mode="cim"))
    params, bn = resnet.init(0, cfg, device="cpu")
    planned = resnet.plan_params(params, cfg.cim)
    x = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(2))
    return planned, bn, x, cfg


def _spans(prof):
    """(start ns, end ns, name) of every program span, by start."""
    out = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
           for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith(P)]
    return sorted(out, key=lambda e: (e[0], -e[1]))


def _parents(spans):
    """Each span's innermost enclosing program span (None at the top)."""
    out, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        assert not stack or e <= stack[-1][1], "spans overlap unnested"
        out.append(stack[-1][2] if stack else None)
        stack.append((s, e, name))
    return out


def _profiled(fn):
    with dispatch.record_resolutions() as log, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof), log


def _children(spans, parents, pass_name):
    """For each span named ``pass_name``, the names of its children."""
    out = []
    for s, e, name in spans:
        if name == pass_name:
            out.append([n for (s2, e2, n), p in zip(spans, parents,
                                                     strict=True)
                        if p == pass_name and s <= s2 and e2 <= e])
    return out


def _assert_engine_triples(children, log):
    """One quantize, macro and epilogue span a macro call, in that
    order, and as many macro calls as dispatch resolved."""
    total = 0
    for names in children:
        engine_names = [n for n in names if n in ENGINE]
        assert engine_names == [P + "engine.quantize", P + "engine.macro",
                                P + "engine.epilogue"] * (
                                    len(engine_names) // 3)
        total += len(engine_names) // 3
    assert total == len(log) > 0


class _Refused(Exception):
    pass


def _refuse(*args, **kwargs):
    raise _Refused("a record function was made with no profiler active")


@pytest.fixture
def no_record_functions(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)


def test_profiler_check_flips_inside_and_outside_profile():
    assert tracing.span("x") is tracing._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        inside = tracing.span("x")
        assert inside is not tracing._OFF
        with inside:
            pass
    assert tracing.span("x") is tracing._OFF


def test_span_is_the_shared_no_op_without_a_profiler(no_record_functions):
    assert tracing.span(P + "a") is tracing.span(P + "b") is tracing._OFF
    with tracing.span(P + "a"), tracing.span(P + "b"):
        pass
    with pytest.raises(_Refused):
        torch._C._profiler._RecordFunctionFast("a")


def test_no_record_function_on_any_path_without_a_profiler(
        no_record_functions):
    plan = engine.plan_weights(torch.randn(32, 8), PAPER_OP_16ROWS)
    policy = CIMPolicy(mode="cim", cim=PAPER_OP_16ROWS)
    y = engine.execute(torch.randn(4, 32), plan, policy)
    assert y.shape == (4, 8)
    tokens = _server().generate(_prompts(), N_TOKENS)
    assert tokens.shape == (2, N_TOKENS)
    planned, bn, x, cfg = _resnet()
    logits, _ = resnet.forward(planned, bn, x, cfg)
    assert logits.shape == (2, 10)


def test_generate_emits_the_table_nested():
    server = _server()
    spans, log = _profiled(lambda: server.generate(_prompts(), N_TOKENS))
    assert {n for _, _, n in spans} == LM_SPANS
    parents = _parents(spans)
    want = {P + "serve.generate": None,
            P + "serve.prefill": P + "serve.generate",
            P + "serve.decode_step": P + "serve.generate"}
    for (_, _, name), parent in zip(spans, parents, strict=True):
        if name in ENGINE:
            assert parent in (P + "serve.prefill", P + "serve.decode_step")
        else:
            assert parent == want[name], name
    names = [n for _, _, n in spans]
    assert names.count(P + "serve.generate") == 1
    assert names.count(P + "serve.prefill") == 1
    assert names.count(P + "serve.decode_step") == N_TOKENS - 1
    children = (_children(spans, parents, P + "serve.prefill")
                + _children(spans, parents, P + "serve.decode_step"))
    _assert_engine_triples(children, log)
    # Every pass makes the same macro calls.
    assert len({len(c) for c in children}) == 1


def test_planned_forward_emits_the_table_nested():
    planned, bn, x, cfg = _resnet()
    spans, log = _profiled(lambda: resnet.forward(planned, bn, x, cfg))
    assert {n for _, _, n in spans} == RESNET_SPANS
    parents = _parents(spans)
    for (_, _, name), parent in zip(spans, parents, strict=True):
        want = None if name == P + "resnet.forward" else P + "resnet.forward"
        assert parent == want, name
    names = [n for _, _, n in spans]
    assert names.count(P + "resnet.forward") == 1
    # The stem and the fc are digital under the paper's policy: every
    # macro conv, and only those, takes one im2col.
    assert names.count(P + "resnet.im2col") == len(log)
    _assert_engine_triples(
        _children(spans, parents, P + "resnet.forward"), log)


def test_continuous_batcher_steps_through_decode_step_spans():
    server = _server()
    batcher = serve.ContinuousBatcher(server)
    batcher.submit(serve.Request(rid=0, prompt=[5, 7, 9], max_new=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batcher.run_until_done()
    names = [n for _, _, n in _spans(prof)]
    # Admission steps the prompt token by token, then two decode steps.
    assert names.count(P + "serve.decode_step") == 3 + 2
    assert set(names) == {P + "serve.decode_step"} | ENGINE


def test_spans_nest_on_one_thread():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span(P + "outer"):
            with tracing.span(P + "inner"):
                torch.ones(2).add_(1)
    spans = _spans(prof)
    assert [n for _, _, n in spans] == [P + "outer", P + "inner"]
    assert _parents(spans) == [None, P + "outer"]
