"""``dispatch_idle.*`` (%): the share of the profiled window in which the
card was idle while the host ran a macro call from ``kernels/dispatch.py``
to the kernel's launch (the ``repro_torch.engine.macro`` span)."""

from perfbench import spans


def read(rec):
    return spans.idle_share(rec, (spans.MACRO,))
