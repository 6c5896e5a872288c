"""``expert_share.*`` (%): the experts that ran through the macro, as a
share of those a pass could run: 100 x the profiled window's
``repro_torch.moe.expert`` spans (one per expert segment) over its
passes x the cell's expert slots a pass (MoE layers x experts). The
masked loop over every expert reads 100; routing reads the share of
(layer, expert) pairs that received a token. None without such spans."""

from perfbench import spans

EXPERT = spans.PREFIX + "moe.expert"


def read(rec):
    slots = getattr(rec.cell, "expert_slots", None)
    if rec.trace is None or not slots:
        return None
    names = [n for _, _, n in rec.trace.host]
    experts = names.count(EXPERT)
    passes = sum(names.count(p) for p in spans.PASSES)
    if not experts or not passes:
        return None
    return 100.0 * experts / (passes * slots)
