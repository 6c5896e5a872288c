"""``graphed_steps.decode`` (%): the share of the profiled window's decode
steps (``repro_torch.serve.decode_step`` spans) that replayed the engine's
captured CUDA graph (a ``repro_torch.serve.decode_graph`` span inside the
step); 0 where every step ran eagerly, no value without decode steps."""

from perfbench import spans

STEP = spans.PREFIX + "serve.decode_step"
GRAPH = spans.PREFIX + "serve.decode_graph"


def read(rec):
    if rec.trace is None:
        return None
    names = [n for _, _, n in rec.trace.host]
    steps = names.count(STEP)
    if not steps:
        return None
    return 100.0 * names.count(GRAPH) / steps
