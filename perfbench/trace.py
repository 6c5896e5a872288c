"""A profiled window on the card and its reduction.

``capture(fn)`` runs ``fn`` once under ``torch.profiler`` (host ops and
CUDA activity) and keeps, from the raw Kineto events, each device
event's interval and name and each host op of the main thread. The
reductions:

  busy_s()          seconds in which any device operation ran (the union
                    of the device intervals)
  kernels()         device events that are kernels (not copies or sets)
  device_ops(10)    device time by operation name, largest first
  idle_gaps(10)     device-idle seconds between device operations, by the
                    innermost host op running at each gap's middle
                    ("python" where none was: the interpreter between
                    ops), largest first
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    window_s: float  # host clock, synchronised at both ends
    calls: int  # calls of the cell in the window
    device: list[tuple[int, int, str]]  # (start ns, end ns, name)
    host: list[tuple[int, int, str]]  # main thread's host ops

    def _union(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) * 1e-9

    def kernels(self) -> list[tuple[int, int, str]]:
        return [ev for ev in self.device if not ev[2].startswith(_NOT_KERNELS)]

    def device_ops(self, top: int = 10) -> list[list]:
        by = collections.Counter()
        for s, e, name in self.device:
            by[name] += (e - s) * 1e-9
        return [[name[:160], secs] for name, secs in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list[list]:
        spans = self._union()
        gaps = [(spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)]
        names = _innermost(self.host, [(a + b) // 2 for a, b in gaps])
        by = collections.Counter()
        for (a, b), name in zip(gaps, names, strict=True):
            by[name] += (b - a) * 1e-9
        return [[name[:160], secs] for name, secs in by.most_common(top)]


def _innermost(host: list[tuple[int, int, str]], times: list[int]
               ) -> list[str]:
    """The innermost host op containing each time (host ops of one
    thread nest), preferring an ``aten::`` op over a runtime call."""
    events = sorted(host, key=lambda e: (e[0], -e[1]))
    starts = [e[0] for e in events]
    order = sorted(range(len(times)), key=times.__getitem__)
    out = ["python"] * len(times)
    stack: list[tuple[int, int, str]] = []
    nxt = 0
    for qi in order:
        t = times[qi]
        hi = bisect.bisect_right(starts, t)
        while nxt < hi:
            ev = events[nxt]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            nxt += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        aten = [ev[2] for ev in stack if ev[2].startswith("aten::")]
        if aten:
            out[qi] = aten[-1]
        elif stack:
            out[qi] = stack[-1][2]
    return out


def capture(fn, calls: int) -> Trace:
    """``fn()`` once under the profiler, synchronised before and after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    threads = collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        item = (start, start + ev.duration_ns(), ev.name())
        if ev.device_type() == DeviceType.CUDA:
            device.append(item)
        else:
            tid = ev.start_thread_id()
            threads[tid] += 1
            host.append((tid, item))
    main = threads.most_common(1)[0][0] if threads else None
    return Trace(window_s=window_s, calls=calls, device=device,
                 host=[item for tid, item in host if tid == main])
