"""granite-3.0-1b-a400m in the port, on the CPU: the routed CIM experts
(``MoEConfig.dispatch='ragged'`` under a CIM policy: each expert through
the macro on its own tokens only) and Granite's four multipliers, held to
the benchmark's plain reference (``perfbench/reference/granite_moe.py``)
and to the masked loop over every expert.

The narrow Granite: 2 layers, d 128, 4 query heads on 2 KV heads, 8
experts of width 64 with top 4, vocab 512, the published multipliers,
weights drawn by the benchmark's adapter in bfloat16. On the CPU the
cim-kernel policy runs B1's plain version.
"""

import dataclasses
import json
import pathlib

import pytest
import torch

from perfbench.adapters import granite_moe as adapter
from perfbench.reference import granite_moe as reference
from repro_torch.core import engine
from repro_torch.models import moe, transformer
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
NARROW = dict(hidden_size=128, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=32,
              num_local_experts=8, num_experts_per_tok=4, vocab_size=512)
MULTIPLIERS = ("embedding_multiplier", "attention_multiplier",
               "residual_multiplier", "logits_scaling")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> dict:
    cfg = json.loads((ROOT / "perfbench/configs/granite-moe-1b.json")
                     .read_text())
    cfg.update(NARROW, **kw)
    return cfg


def _planned(cfg: dict, seed: int = 3):
    w = adapter.make_weights(cfg, seed, "cpu")
    pcfg = adapter.program_config(cfg)
    return w, pcfg, engine.plan_params(adapter.program_params(w),
                                       policy=pcfg.cim)


def _prompts(cfg, b=2, s=12, seed=1):
    return torch.randint(0, cfg["vocab_size"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def test_program_config_is_the_published_model():
    cfg = _cfg()
    pcfg = adapter.program_config(cfg)
    assert (pcfg.embedding_multiplier, pcfg.attention_multiplier,
            pcfg.residual_multiplier, pcfg.logits_scaling) == (
        12.0, 0.015625, 0.22, 6.0)
    assert pcfg.attn_scale == 0.015625
    assert pcfg.moe.dispatch == "ragged" and pcfg.moe.top_k == 4
    assert pcfg.cim.mode == "cim-kernel"


def test_served_tokens_and_logits_equal_the_reference():
    """A prefill and 3 decode steps through the engine's cache against
    the reference teacher-forced on the served tokens: the tokens equal
    the reference's argmax and every step's logits equal bit for bit, no
    tolerance. The reference computes each operation in the port's
    dtype and order (the router's weights too), and on the CPU the
    attention over the padded cache sums the reference's keys in the
    same order, its masked keys adding exact zeros. Any tolerance would
    hide a real fault: through the per-tensor activation quantizers one
    bfloat16 step in one expert weight moves the served logits by a
    large share of the float8 control's gap at the published depth."""
    cfg = _cfg()
    w = adapter.make_weights(cfg, 3, "cpu")
    pcfg = adapter.program_config(cfg)
    prompts = _prompts(cfg)
    eng = ServeEngine(adapter.program_params(w), pcfg, max_len=16, batch=2,
                      plan=True, device="cpu")
    logits = eng._prefill(prompts)
    want, toks = [logits], [logits.argmax(-1)]
    for j in range(3):
        logits = eng._decode_step(toks[-1], 12 + j)
        want.append(logits)
        toks.append(logits.argmax(-1))
    want = torch.stack(want, 1)[..., :cfg["vocab_size"]].float()
    served = torch.stack(toks, 1)
    eng2 = ServeEngine(adapter.program_params(w), pcfg, max_len=16, batch=2,
                       plan=True, device="cpu")
    assert torch.equal(torch.from_numpy(eng2.generate(prompts, 4)).long(),
                       served)
    ref = reference.GraniteMoe(adapter.reference_weights(w), cfg)
    got = ref.serve(prompts, served)
    assert torch.equal(got.argmax(-1), served)
    assert torch.equal(got, want)


def _moe_inputs(cfg, top_k, tokens=6, seed=4):
    """One planned MoE layer of the narrow model, its config with
    ``top_k`` and an input [1, tokens, d] in bfloat16."""
    _, pcfg, planned = _planned(cfg)
    layer = transformer._unit(planned["units"], 0)["layer_00"]["moe"]
    pcfg = _moe(pcfg, top_k=top_k)
    x = torch.randn(1, tokens, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(seed))
    return layer, pcfg, x.to(torch.bfloat16)


def _moe(pcfg, **kw):
    return pcfg.replace(moe=dataclasses.replace(pcfg.moe, **kw))


def test_routed_equals_masked_loop_when_every_token_takes_every_expert():
    """top_k = n_experts: every expert's segment is every token in order,
    so its quantizer range and outputs are the masked loop's, and the
    combine adds in the same expert order: equal bit for bit."""
    cfg = _cfg()
    layer, pcfg, x = _moe_inputs(cfg, top_k=8)
    grouped = _moe(pcfg, dispatch="grouped")
    with torch.no_grad():
        routed, _ = moe.moe_apply(layer, x, pcfg, policy=pcfg.cim)
        masked, _ = moe.moe_apply(layer, x, grouped, policy=grouped.cim)
    assert torch.equal(routed, masked)


def _record(monkeypatch, calls):
    real = engine.execute

    def rec(x, plan, policy, **kw):
        calls.append(x.shape[0])
        return real(x, plan, policy, **kw)

    monkeypatch.setattr(engine, "execute", rec)


@pytest.mark.parametrize("top_k", [1, 2])
def test_idle_experts_make_no_macro_call(top_k, monkeypatch):
    """3 tokens with top 1 or 2 of 8 experts: only the experts that
    received a token run, three macro calls each at M = its tokens; the
    masked loop makes 3 x 8 at M = 3."""
    cfg = _cfg()
    layer, pcfg, x = _moe_inputs(cfg, top_k=top_k, tokens=3)
    with torch.no_grad():
        _, top_e, _ = moe._router(layer, x[0], pcfg.moe)
    sizes = torch.bincount(top_e.reshape(-1), minlength=8)
    active = sizes[sizes > 0].tolist()
    assert len(active) < 8
    calls = []
    _record(monkeypatch, calls)
    with torch.no_grad():
        moe.moe_apply(layer, x, pcfg, policy=pcfg.cim)
    assert calls == [m for m in active for _ in range(3)]
    calls.clear()
    grouped = _moe(pcfg, dispatch="grouped")
    with torch.no_grad():
        moe.moe_apply(layer, x, grouped, policy=grouped.cim)
    assert calls == [3] * 24


def test_spans_route_and_one_expert_span_a_segment():
    """Under a profiler: ``moe.route`` spans cover no macro call, and one
    ``moe.expert`` span encloses each non-empty segment's three calls."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    layer, pcfg, x = _moe_inputs(cfg, top_k=2, tokens=3)
    with torch.no_grad():
        _, top_e, _ = moe._router(layer, x[0], pcfg.moe)
    active = int((torch.bincount(top_e.reshape(-1), minlength=8) > 0).sum())
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        moe.moe_apply(layer, x, pcfg, policy=pcfg.cim)
    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("repro_torch."))
    names = [n for _, _, n in evs]
    assert names.count("repro_torch.moe.expert") == active
    assert names.count("repro_torch.moe.route") == 3
    macros = [(s, e) for s, e, n in evs if n == "repro_torch.engine.macro"]
    assert len(macros) == 3 * active

    def inside(s, e):
        return sum(s <= ms and me <= e for ms, me in macros)

    for s, e, n in evs:
        if n == "repro_torch.moe.route":
            assert inside(s, e) == 0
        elif n == "repro_torch.moe.expert":
            assert inside(s, e) == 3


@pytest.mark.parametrize("name", MULTIPLIERS)
def test_each_multiplier_is_read(name):
    """Each of the four multipliers, set alone at its published value with
    the others neutral, changes the prefill's logits."""
    neutral = dict(embedding_multiplier=1.0, attention_multiplier=0.0,
                   residual_multiplier=1.0, logits_scaling=1.0)
    published = _cfg()
    _, pcfg, planned = _planned(_cfg(**neutral))
    prompts = _prompts(published)

    def logits(c):
        caches = transformer.init_caches(c, 2, 12, device="cpu")
        with torch.no_grad():
            return transformer.prefill(planned, prompts, caches, c)[0]

    base = logits(pcfg)
    changed = logits(pcfg.replace(**{name: published[name]}))
    assert not torch.equal(base, changed)
    if name == "logits_scaling":
        real = slice(0, published["vocab_size"])
        assert torch.equal(changed[:, real], base[:, real] / 6.0)


def test_reference_pass_macs_by_hand():
    """The reference's count for one decode step of the narrow model at
    batch 2 and position 12: per token and layer 128 x 128 (q) + 2 x 128
    x 64 (k, v) + 128 x 128 (o) = 49,152, the router 128 x 8 = 1,024, 4
    experts x 3 x 128 x 64 = 98,304; attention 2 x 128 x 13 keys x 2;
    the head 2 x 128 x 512."""
    cfg = _cfg()
    per_token = 49_152 + 1_024 + 98_304
    want = 2 * (2 * per_token + 2 * 128 * 13 * 2) + 2 * 128 * 512
    assert reference.pass_macs(cfg, 2, 12, 1) == want
