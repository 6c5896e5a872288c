"""``launches_per_step.*`` (launches/step): kernels on the card in the
profiled window (copies and sets left out) per model pass: a ResNet
forward, an LM prefill or decode step."""


def read(rec):
    if rec.trace is None or rec.trace.calls == 0:
        return None
    return len(rec.trace.kernels()) / (rec.trace.calls
                                       * rec.cell.steps_per_call)
