"""``route_idle.*`` (%): the share of the profiled window in which the
card was idle while the host ran a MoE layer's routing: the router and
top-k, the sort by expert and the host read of the segment sizes, the
gathers and the combine (the ``repro_torch.moe.route`` span). A part of
``model_idle``: the span lies inside a pass and outside the engine's."""

from perfbench import spans

ROUTE = spans.PREFIX + "moe.route"


def read(rec):
    return spans.idle_share(rec, (ROUTE,))
