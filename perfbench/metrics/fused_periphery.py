"""``fused_periphery.*`` (%): the share of the profiled window's activation
quantizers (``repro_torch.engine.quantize`` spans) that ran as the
engine's hand-written kernels (a ``repro_torch.engine.quantize_kernel``
span inside the quantizer); 0 where every quantizer ran as ATen ops, no
value without quantizer spans (a replayed decode graph makes none)."""

from perfbench import spans

KERNEL = spans.PREFIX + "engine.quantize_kernel"


def read(rec):
    if rec.trace is None:
        return None
    names = [n for _, _, n in rec.trace.host]
    quantizers = names.count(spans.QUANTIZE)
    if not quantizers:
        return None
    return 100.0 * names.count(KERNEL) / quantizers
