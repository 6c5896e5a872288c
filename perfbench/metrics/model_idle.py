"""``model_idle.*`` (%): the share of the profiled window in which the
card was idle while the host ran a model pass (``repro_torch.resnet.
forward``, ``serve.prefill``, ``serve.decode_step``) outside the engine's
three spans: the model's own ops and the interpreter between them."""

from perfbench import spans


def read(rec):
    return spans.idle_share(rec, spans.PASSES, less=spans.ENGINE)
