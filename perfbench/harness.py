"""One run of one benchmark cell: set-up, the measured window, the
optional profiled window, the check against the plain reference, and
the result line.

Everything a cell is made of is found by name: the workload in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``, whose
``family`` names the adapter ``adapters/<family>.py``) and its traffic
(``traffic/<name>.json``); its check's limits are
``limits/<workload>.json``; each per-layer metric is read by
``metrics/<family>.py``, the part of its name before the first dot. The
arithmetic of the end-to-end metrics lives here: a traffic file maps
each of the cell's end-to-end metrics to one of

  "rate"          work units of all the window's calls over the window
  "call_p95_ms"   95th percentile of every call's host-clock latency

and ``setup_s`` is process start to the first timed call.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import pathlib
import random
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
MACRO_RESOLUTION = ("p8t", "cuda")


class Refused(Exception):
    """The run cannot produce a result (no card, JAX loaded, a missing
    program): reported on stderr, no result line, a non-zero exit."""


def load_cell(workload: str) -> dict:
    """Everything BENCHMARK.json and the cell's files say about one
    workload."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        wl = next(w for w in manifest["workloads"] if w["name"] == workload)
    except StopIteration:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json") from None
    entry = next(c for c in manifest["configs"] if c["name"] == wl["config"])

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    return dict(
        workload=wl,
        config=json.loads((ROOT / entry["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in manifest["per_layer"] if applies(m)],
    )


class Stages:
    """Seconds of each named set-up stage (``with stages("plan"): ...``),
    synchronised with the card at the end of each."""

    def __init__(self, sync):
        self.seconds: dict[str, float] = {}
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t0)


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader sees."""

    cell: object  # the adapter's Cell
    calls: int  # calls in the unprofiled window
    window_s: float  # its length, whole calls
    trace: object | None  # trace.Trace of the profiled window


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def pick_calls(n_calls: int, k: int, pool: int, seed: int) -> list[int]:
    """k of the window's calls, drawn from the seed, on distinct inputs of
    the cell's pool (call i runs input i % pool)."""
    order = list(range(n_calls))
    random.Random(seed).shuffle(order)
    seen, out = set(), []
    for i in order:
        if i % pool not in seen and len(out) < k:
            seen.add(i % pool)
            out.append(i)
    return sorted(out)


def check_limits(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def run_cell(spec: dict, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, sync=None, stages=None) -> dict:
    """Set up, measure, check; return the result (without printing)."""
    import torch

    sync = sync or torch.cuda.synchronize
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    tf32 = cfg.get("tf32", False)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    stages = stages or Stages(sync)
    with stages("imports"):
        try:
            from repro_torch.kernels import build, dispatch
        except ImportError as e:
            raise Refused(f"the program (repro_torch) does not import: {e}"
                          ) from e
        adapter = importlib.import_module(f"perfbench.adapters.{cfg['family']}")
    if device != "cpu":
        with stages("library"):
            build.library("gpq_matmul")
        torch.cuda.reset_peak_memory_stats()
    cell = adapter.Cell(cfg, traffic, seed, device, stages)
    sync()
    setup_s = time.perf_counter() - t_start

    latencies: list[float] = []
    units = 0
    with dispatch.record_resolutions() as resolutions:
        w0 = time.perf_counter()
        while not latencies or time.perf_counter() - w0 < seconds:
            t = time.perf_counter()
            units += cell.call(len(latencies))
            latencies.append(time.perf_counter() - t)
        window_s = time.perf_counter() - w0
        n_calls = len(latencies)
        profiled = None
        if trace:
            from perfbench import trace as trace_lib

            k = traffic["trace_calls"]
            profiled = trace_lib.capture(
                lambda: [cell.call(n_calls + j) for j in range(k)], k)
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)
    found = forbidden_loaded()
    if found:
        raise Refused(f"modules loaded in this process: {found}")

    metrics: dict = {}
    if trace:
        rec = Record(cell, n_calls, window_s, profiled)
        for m in spec["per_layer"]:
            family = importlib.import_module(
                f"perfbench.metrics.{m['name'].split('.')[0]}")
            value = family.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            kind = "setup" if m["name"] == "setup_s" else traffic["metrics"][
                m["name"]]
            value = {
                "setup": lambda: setup_s,
                "rate": lambda: units / window_s,
                "call_p95_ms": lambda: 1e3 * percentile(latencies, 95.0),
            }[kind]()
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The check, once the window has closed and the program's state is
    # freed: the reference never sets the memory peak.
    off_kernel = sum((r.key.variant, r.key.backend) != MACRO_RESOLUTION
                     for r in resolutions)
    picks = pick_calls(n_calls, limits["check_calls"], cell.pool_n, seed)
    cell.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = dict(cell.compare(picks), off_kernel=off_kernel)
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": numbers[k], "limit": limits["limits"][k]}
              for k in limits["limits"]}
    result = {
        "correct": check_limits(numbers, limits["limits"]),
        "attempted": n_calls,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device != "cpu" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                     else "cpu"),
            "count": spec["workload"]["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    if profiled is not None:
        result["device"]["busy_s"] = profiled.busy_s()
        result["device"]["window_s"] = profiled.window_s
        result["breakdown"] = {"device_ops": profiled.device_ops(10),
                               "idle_gaps": profiled.idle_gaps(10)}
    result["setup_stages"] = stages.seconds
    result["checked_calls"] = picks
    result["check_s"] = check_s
    result["checks"] = checks
    return result


def percentile(values: list[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="Run one benchmark cell once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program builds its kernels under build/kernels/ itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cache_dirs()
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    try:
        spec = load_cell(args.workload)
        stages = Stages(lambda: None)
        with stages("imports"):
            import torch

        torch.set_num_threads(2)
        chips = spec["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA device(s); "
                          f"torch.cuda.is_available() is "
                          f"{torch.cuda.is_available()}, "
                          f"{torch.cuda.device_count()} device(s)")
        stages.sync = torch.cuda.synchronize
        with stages("cuda_init"):
            torch.empty(1, device="cuda")
        result = run_cell(spec, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          t_start=t_start, stages=stages)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for stage, secs in result["setup_stages"].items():
        print(f"setup {stage} {secs:.3f} s", file=sys.stderr)
    print(f"check took {result['check_s']:.3f} s", file=sys.stderr)
    if "breakdown" in result:
        for name, secs in result["breakdown"]["device_ops"]:
            print(f"device op {secs:.6f} s {name}", file=sys.stderr)
        for name, secs in result["breakdown"]["idle_gaps"]:
            print(f"idle gap {secs:.6f} s {name}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
