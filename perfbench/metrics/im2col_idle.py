"""``im2col_idle.*`` (%): the share of the profiled window in which the
card was idle while the host ran the ResNet's im2col, the pad and the
unfold (the ``repro_torch.resnet.im2col`` span)."""

from perfbench import spans


def read(rec):
    return spans.idle_share(rec, (spans.IM2COL,))
