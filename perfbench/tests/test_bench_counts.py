"""The operation and byte counts behind step_mfu and macro_roofline,
against numbers worked by hand for each cell's shapes."""

import pytest

from perfbench import harness, peaks
from perfbench.adapters import lm, resnet


def _cell(name):
    spec = harness.load_cell(name)
    return spec["config"], spec["traffic"]


def test_resnet20_forward_macs():
    cfg, traffic = _cell("resnet20-cifar.eval-b256")
    # An image: stem 32*32*27*16 = 442,368; stage 0, six 3x3 16->16 convs
    # at 32x32: 6 * 2,359,296; stages 1 and 2 each 13,107,200 (the strided
    # conv 1,179,648, five 3x3 convs 5 * 2,359,296, the 1x1 projection
    # 131,072); fc 64 * 10.
    per_image = 442_368 + 6 * 2_359_296 + 2 * 13_107_200 + 640
    assert per_image == 40_813_184
    assert resnet.model_macs(cfg, traffic) == 256 * per_image


def test_resnet20_macro_products_and_bound():
    cfg, traffic = _cell("resnet20-cifar.eval-b256")
    prods = resnet.macro_products(cfg, traffic)
    assert len(prods) == 20  # 9 blocks x 2 convs + 2 projections
    assert prods[0] == dict(m=262_144, k=144, n=16, in_elems=4_194_304,
                            macro=True, out_bytes=4)
    # Every conv is byte-bound at batch 256; the bytes (4-bit inputs of the
    # feature map, 8-bit weights, float32 outputs): stage 0 6 * 18,876,672,
    # stage 1 10,490,368 + 5 * 9,446,400 + 10,486,272, stage 2 5,261,312 +
    # 5 * 4,755,456 + 5,244,928.
    nbytes = (6 * 18_876_672 + 10_490_368 + 5 * 9_446_400 + 10_486_272
              + 5_261_312 + 5 * 4_755_456 + 5_244_928)
    assert nbytes == 215_752_192
    bound = sum(peaks.macro_bound_s(p, 4, 8) for p in prods)
    assert bound == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_qwen2_decode_call_macs():
    cfg, traffic = _cell("qwen2-0.5b.decode-b4")
    # A token's projections in a layer: 896*896 (q) + 2 * 896*128 (k, v)
    # + 896*896 (o) + 3 * 896*4864 (gate, up, down) = 14,909,440.
    # Prefill of 4 x 128: 24 * (512 * 14,909,440 + 2*896*4 * 8256) plus
    # the head at the last positions 4 * 896 * 151,936; then 31 decode
    # steps at positions 128..158: 24 * (31 * 4 * 14,909,440 + 7168 *
    # 4464) + 31 * 544,538,624.
    prefill = 24 * (512 * 14_909_440 + 7168 * 8256) + 544_538_624
    decode = 24 * (31 * 59_637_760 + 7168 * 4464) + 31 * 544_538_624
    assert prefill == 185_172_033_536
    assert decode == 62_019_141_632
    assert lm.model_macs(cfg, traffic) == prefill + decode


def test_qwen2_prefill_call_macs_and_bound():
    cfg, traffic = _cell("qwen2-0.5b.prefill-b4x1024")
    want = 24 * (4096 * 14_909_440 + 7168 * 524_800) + 544_538_624
    assert lm.model_macs(cfg, traffic) == want == 1_556_484_521_984
    prods = lm.macro_products(cfg, traffic)
    assert len(prods) == 24 * 7
    by_n = {(p["k"], p["n"]): p for p in prods}
    # q at M = 4096 is bound by operations, k by bytes.
    assert peaks.macro_bound_s(by_n[896, 896], 4, 8) == pytest.approx(
        2 * 4096 * 896 * 896 / 1979e12, rel=1e-12)
    assert peaks.macro_bound_s(by_n[896, 128], 4, 8) == pytest.approx(
        (1_835_008 + 114_688 + 1_048_576) / 3.35e12, rel=1e-12)


def test_qwen2_decode_products():
    cfg, traffic = _cell("qwen2-0.5b.decode-b4")
    prods = lm.macro_products(cfg, traffic)
    assert len(prods) == 32 * 24 * 7  # 5376: the prefill and 31 steps
    gate = next(p for p in prods if p["m"] == 4 and p["n"] == 4864)
    # M = 4: 4 * 896 codes at 4 bits, 896 * 4864 weight bytes, 4 * 4864
    # bfloat16 outputs.
    assert peaks.macro_bound_s(gate, 4, 8) == pytest.approx(
        (1792 + 4_358_144 + 38_912) / 3.35e12, rel=1e-12)
