"""``periphery_idle.*`` (%): the share of the profiled window in which the
card was idle while the host ran the macro's digital periphery: the
engine's activation quantizer and its dequant epilogue (the
``repro_torch.engine.quantize`` and ``.epilogue`` spans)."""

from perfbench import spans


def read(rec):
    return spans.idle_share(rec, (spans.QUANTIZE, spans.EPILOGUE))
