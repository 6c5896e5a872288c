"""Readings for a cell's check limits, on the card at the cell's size.

  python3 perfbench/probe.py --workload <name> --seeds 1,2,... \
      [--control-seeds 7,8,9]

For every seed, in one process: the cell's set-up, as many calls as the
check picks (the window's own call), then the check's numbers for the
program (the sound reading) and, for a control seed, for the control:
the plain reference in the next precision below the configuration's
(TF32 products for float32, float8 e4m3 activations for bfloat16) in
the program's place. One JSON line per seed on standard output. A limit
lies between the largest sound reading and the smallest control reading
(``limits/<workload>.json`` records both).
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402


def readings(spec: dict, seed: int, *, control: bool, device: str,
             sync) -> dict:
    """The check's numbers for one seed: {"sound": {...}[, "control":
    {...}]}, with the reference's seconds."""
    import torch
    import importlib

    cfg, traffic = spec["config"], spec["traffic"]
    tf32 = cfg.get("tf32", False)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    adapter = importlib.import_module(f"perfbench.adapters.{cfg['family']}")
    stages = harness.Stages(sync)
    cell = adapter.Cell(cfg, traffic, seed, device, stages)
    k = spec["limits"]["check_calls"]
    for i in range(k):
        cell.call(i)
    picks = harness.pick_calls(k, k, cell.pool_n, seed)
    cell.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"seed": seed, "picks": picks, "sound": cell.compare(picks)}
    out["reference_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        out["control"] = cell.compare(picks, cell.control_outputs(picks))
        out["control_s"] = time.perf_counter() - t0
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(controls - set(seeds))
    for seed in seeds:
        r = readings(spec, seed, control=seed in controls, device="cuda",
                     sync=torch.cuda.synchronize)
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
