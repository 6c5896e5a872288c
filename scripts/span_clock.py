"""The program's spans against the card's kernels in one benchmark cell.

    PYTHONPATH=src:. python3 scripts/span_clock.py --workload <cell> \
        --seed <n> [--calls <k>]

Sets the cell up as ``perfbench/run.py`` does, profiles ``k`` calls
(the traffic's ``trace_calls`` by default) with ``perfbench.trace``, and
prints one JSON line:

  spans        each ``repro_torch.`` span's count in the window
  macro_spans  ``engine.macro`` spans; ``b1_kernels`` the macro kernels
               (a replayed decode graph launches its B1 kernels with no
               span on the host: only the prefill's match there)
  late         indices i at which the i-th macro kernel starts before the
               i-th ``engine.macro`` span (the spans and the kernels
               share the profiler's clock, so none should)
  idle         ``device_idle`` and the per-layer idle shares (%)
  covered      the layers' shares over ``device_idle``
  span_off_ns  ns per ``tracing.span`` entered and left with no profiler
               active, the empty loop's time taken off

It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import time

import torch

from perfbench import harness, spans
from perfbench import trace as trace_lib
from perfbench.metrics import (device_idle, dispatch_idle, im2col_idle,
                               macro_roofline, model_idle, periphery_idle)

READERS = {"device_idle": device_idle, "periphery_idle": periphery_idle,
           "dispatch_idle": dispatch_idle, "model_idle": model_idle,
           "im2col_idle": im2col_idle}


def span_off_ns(n: int = 1_000_000) -> float:
    from repro_torch import tracing

    def empty():
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return time.perf_counter_ns() - t

    def spanned():
        t = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("repro_torch.engine.macro"):
                pass
        return time.perf_counter_ns() - t

    return (min(spanned() for _ in range(5))
            - min(empty() for _ in range(5))) / n


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=0)
    args = p.parse_args()
    harness.cache_dirs()
    spec = harness.load_cell(args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    tf32 = cfg.get("tf32", False)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    from repro_torch.kernels import build

    build.library("gpq_matmul")
    adapter = importlib.import_module(f"perfbench.adapters.{cfg['family']}")
    cell = adapter.Cell(cfg, traffic, args.seed, "cuda",
                        harness.Stages(torch.cuda.synchronize))
    k = args.calls or traffic["trace_calls"]
    t = trace_lib.capture(lambda: [cell.call(j) for j in range(k)], k)

    counts = collections.Counter(n for _, _, n in t.host
                                 if n.startswith(spans.PREFIX))
    macro = sorted(s for s, _, n in t.host if n == spans.MACRO)
    b1 = sorted(s for s, _, n in t.kernels()
                if macro_roofline.B1_KERNEL.search(n))
    late = [i for i, (m, b) in enumerate(zip(macro, b1)) if b < m]
    rec = harness.Record(cell, 0, 0.0, t)
    idle = {name: r.read(rec) for name, r in READERS.items()}
    parts = [idle[n] for n in ("periphery_idle", "dispatch_idle",
                               "model_idle")]
    covered = (sum(parts) / idle["device_idle"]
               if None not in parts and idle["device_idle"] else None)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "calls": k,
        "window_s": t.window_s, "busy_s": t.busy_s(),
        "passes": k * cell.steps_per_call, "spans": dict(counts),
        "macro_spans": len(macro), "b1_kernels": len(b1),
        "kernels": len(t.kernels()), "late": late[:20],
        "n_late": len(late), "idle": idle, "covered": covered,
        "span_off_ns": span_off_ns(),
        "card": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
