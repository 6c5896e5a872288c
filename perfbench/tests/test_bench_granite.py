"""The granite cell (``granite-moe-1b.decode-b4``): its operation and byte
counts against numbers worked by hand, its check's control at a small
size on the CPU, and the MoE layer's readers (``route_idle``,
``expert_share``) on built traces."""

import types

import pytest

from perfbench import harness, peaks, probe
from perfbench.adapters import granite_moe
from perfbench.metrics import expert_share, model_idle, route_idle
from perfbench.trace import Trace

CELL = "granite-moe-1b.decode-b4"
P = "repro_torch."


def _cell():
    spec = harness.load_cell(CELL)
    return spec["config"], spec["traffic"]


def test_decode_call_macs():
    cfg, traffic = _cell()
    # A token's work in a layer: 1024*1024 (q) + 2 * 1024*512 (k, v) +
    # 1024*1024 (o) = 3,145,728; the router 1024*32 = 32,768; 8 experts x
    # 3 x 1024*512 = 12,582,912: 15,761,408 in all. Prefill of 4 x 128:
    # 24 * (512 * 15,761,408 + 2*1024*4 * 8256 keys) plus the head at the
    # last positions 4 * 1024 * 49,155 = 201,338,880; then 7 decode steps
    # at positions 128..134 (924 keys): 24 * (28 * 15,761,408 + 8192 *
    # 924) + 7 * 201,338,880.
    prefill = 24 * (512 * 15_761_408 + 8192 * 8256) + 201_338_880
    decode = 24 * (28 * 15_761_408 + 8192 * 924) + 7 * 201_338_880
    assert prefill == 195_500_716_032
    assert decode == 12_182_704_128
    assert granite_moe.model_macs(cfg, traffic) == prefill + decode


def test_decode_call_products_and_bounds():
    cfg, traffic = _cell()
    prods = granite_moe.macro_products(cfg, traffic)
    assert len(prods) == 8 * 24 * (4 + 32 * 3)  # 19,200
    # The experts' products of a pass and layer hold the routed MACs
    # exactly: M = tokens * 8 / 32 for each of 32 experts.
    layer = prods[:100]  # the prefill's first layer
    experts = [p for p in layer if p["m"] != 512]
    assert len(experts) == 96 and {p["m"] for p in experts} == {128}
    assert sum(p["m"] * p["k"] * p["n"] for p in experts) == \
        512 * 8 * 3 * 1024 * 512
    # A decode step's expert gate at M = 1: 1 * 1024 codes at 4 bits,
    # 1024 * 512 weight bytes, 512 bfloat16 outputs; byte-bound.
    gate = next(p for p in prods[-100:] if p["m"] == 1 and p["n"] == 512)
    assert peaks.macro_bound_s(gate, 4, 8) == pytest.approx(
        (512 + 524_288 + 1024) / 3.35e12, rel=1e-12)
    # The prefill's q at M = 512 is byte-bound too: 512 * 1024 codes at 4
    # bits, 1024 * 1024 weight bytes, 512 * 1024 bfloat16 outputs (the
    # operations alone would take 0.54 us).
    q = layer[0]
    assert (q["m"], q["k"], q["n"]) == (512, 1024, 1024)
    assert peaks.macro_bound_s(q, 4, 8) == pytest.approx(
        (262_144 + 1_048_576 + 1_048_576) / 3.35e12, rel=1e-12)


def test_the_control_is_far_from_the_sound_reading():
    """At a small size on the CPU (d 256, 6 layers, 8 experts top 4,
    vocab 4096) the program's served tokens are the reference's bit for
    bit (``token_gap`` 0.0), and the reference in float8 e4m3
    activations in the program's place reads 0.305. The cell's limit is
    set at the published size from the card's readings
    (``limits/granite-moe-1b.decode-b4.json``), which a small size
    cannot reach."""
    spec = harness.load_cell(CELL)
    spec["config"].update(hidden_size=256, num_hidden_layers=6,
                          num_attention_heads=4, num_key_value_heads=2,
                          num_local_experts=8, num_experts_per_tok=4,
                          vocab_size=4096)
    spec["traffic"].update(pool=2, warmup=1, prompt_len=16, new_tokens=4,
                           max_len=20)
    r = probe.readings(spec, 2**31 + 99, control=True, device="cpu",
                       sync=lambda: None)
    assert r["sound"]["token_gap"] == 0.0
    assert r["control"]["token_gap"] > 0.25


def _rec(trace, slots=24 * 32):
    return types.SimpleNamespace(trace=trace,
                                 cell=types.SimpleNamespace(
                                     expert_slots=slots))


def _moe_trace():
    """Two decode steps 0-1000 and 1000-2000 of a one-layer, four-expert
    model. Step 1: route 0-100, experts 100-300 and 300-500 (a macro call
    inside each), route 500-600. Step 2: route 1000-1100, one expert
    1100-1300, route 1300-1400. The device runs 50-80, 150-250 and
    1150-1250."""
    host = [(0, 1000, P + "serve.decode_step"),
            (0, 100, P + "moe.route"),
            (100, 300, P + "moe.expert"), (150, 250, P + "engine.macro"),
            (300, 500, P + "moe.expert"), (350, 450, P + "engine.macro"),
            (500, 600, P + "moe.route"),
            (1000, 2000, P + "serve.decode_step"),
            (1000, 1100, P + "moe.route"),
            (1100, 1300, P + "moe.expert"), (1150, 1250, P + "engine.macro"),
            (1300, 1400, P + "moe.route")]
    device = [(50, 80, "k"), (150, 250, "plane_mma_kernel"),
              (1150, 1250, "plane_mma_kernel")]
    return Trace(window_s=2000e-9, calls=1, device=device, host=host)


def test_expert_share_counts_segments_over_slots():
    # 3 expert spans over 2 passes x 4 slots.
    assert expert_share.read(_rec(_moe_trace(), slots=4)) == \
        pytest.approx(37.5)
    # The masked loop: every slot of every pass.
    t = _moe_trace()
    t.host += [(600, 700, P + "moe.expert"), (700, 800, P + "moe.expert"),
               (1400, 1500, P + "moe.expert"), (1500, 1600, P + "moe.expert"),
               (1600, 1700, P + "moe.expert")]
    assert expert_share.read(_rec(t, slots=4)) == pytest.approx(100.0)


def test_expert_share_is_none_without_spans_or_slots():
    t = _moe_trace()
    assert expert_share.read(_rec(t, slots=None)) is None
    assert expert_share.read(_rec(None)) is None
    t.host = [h for h in t.host if h[2] != P + "moe.expert"]
    assert expert_share.read(_rec(t)) is None


def test_route_idle_is_the_route_spans_off_the_device_and_part_of_model():
    rec = _rec(_moe_trace())
    # Route spans 0-100 (device 50-80), 500-600, 1000-1100, 1300-1400:
    # 70 + 100 + 100 + 100 = 370 ns idle of 2000.
    assert route_idle.read(rec) == pytest.approx(18.5)
    assert route_idle.read(rec) <= model_idle.read(rec)
    t = _moe_trace()
    t.host = [h for h in t.host if h[2] != P + "moe.route"]
    assert route_idle.read(_rec(t)) is None
