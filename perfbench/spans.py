"""The card's idle time under the program's spans.

The program opens named spans on the host (``repro_torch.tracing``); in a
profiled window they are host events of the main thread
(``Trace.host``), on the clock of the device events. For a set S of
span names, idle(S) is the length of the union of S's intervals less its
overlap with the union of the device intervals: the time in which the
host was inside S and the card ran nothing. A per-layer share is
100 x idle(S) / the window.

Sets of disjoint spans give disjoint idle times, so the engine's, the
dispatch's and the model's shares add up to at most ``device_idle``.
"""

from __future__ import annotations

PREFIX = "repro_torch."
QUANTIZE = PREFIX + "engine.quantize"
MACRO = PREFIX + "engine.macro"
EPILOGUE = PREFIX + "engine.epilogue"
ENGINE = (QUANTIZE, MACRO, EPILOGUE)
PASSES = (PREFIX + "resnet.forward", PREFIX + "serve.prefill",
          PREFIX + "serve.decode_step")
IM2COL = PREFIX + "resnet.im2col"


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint, merged intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def minus(a, b) -> list[tuple[int, int]]:
    """a less b, both as ``union`` returns them."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def idle_ns(trace, names, less=()) -> int | None:
    """Nanoseconds of idle(S) for S the spans named in ``names`` less
    those named in ``less``; None when the trace holds none of ``names``."""
    spans = [(s, e) for s, e, n in trace.host if n in names]
    if not spans:
        return None
    region = union(spans)
    if less:
        region = minus(region, union(
            (s, e) for s, e, n in trace.host if n in less))
    busy = union((s, e) for s, e, _ in trace.device)
    return sum(e - s for s, e in minus(region, busy))


def idle_share(rec, names, less=()) -> float | None:
    """100 x idle(S) over the profiled window, or None (no trace, or none
    of the spans)."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    ns = idle_ns(rec.trace, names, less)
    return None if ns is None else 100.0 * ns * 1e-9 / rec.trace.window_s
