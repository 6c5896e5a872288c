"""Batched serving: continuous batching over a fixed decode batch, KV and
state caches, CIM-executed weight matmuls.

Five requests of different lengths share two decode slots; finished
slots are refilled mid-flight. Runs the rwkv6 (attention-free, O(1)
state) and qwen2 (GQA KV cache) smoke backbones, fp vs cim-exact.

  PYTHONPATH=src python -m repro_torch.examples.serve_cim [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import convert
from repro_torch.configs.base import CIMPolicy, get_config
from repro_torch.core.params import PAPER_OP_16ROWS
from repro_torch.device import full_float32, resolve
from repro_torch.models import transformer
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine

ARCHS = ("qwen2_0_5b", "rwkv6_1_6b")
MODES = ("fp", "cim-exact")
# (prompt length, max new tokens) of the five requests
SCHEDULE = ((4, 6), (8, 4), (3, 8), (6, 5), (5, 7))


def demo(arch: str, mode: str, device="cuda") -> dict[int, list[int]]:
    """Serve the five requests; each request's generated tokens by id."""
    cfg = get_config(arch, smoke=True)
    if mode != "fp":
        cfg = cfg.replace(cim=CIMPolicy(mode=mode, cim=PAPER_OP_16ROWS))
    # Drawn on the host, so every device serves the same weights.
    params = convert.to_torch(transformer.init(0, cfg, device="cpu"),
                              device=device)
    # plan=True precomputes the weight-stationary CIM state once
    # (core.engine.plan_params); every decode step then skips the
    # weight-side quantize/colsum work.
    engine = ServeEngine(params, cfg, max_len=96, batch=2,
                         plan=(mode != "fp"), device=device)
    batcher = ContinuousBatcher(engine, eos_token=-1)

    rng = np.random.default_rng(0)
    for rid, (plen, gen) in enumerate(SCHEDULE):
        batcher.submit(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new=gen))
    t0 = time.time()
    done = batcher.run_until_done()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"{arch:12s} mode={mode:9s} {len(done)} requests, "
          f"{toks} tokens in {dt:.1f}s")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req{r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")
    return {r.rid: list(r.generated) for r in done}


@full_float32()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device, error=SystemExit)
    out = {(arch, mode): demo(arch, mode, device)
           for arch in ARCHS for mode in MODES}
    print("\nContinuous batching: requests 2..4 were admitted into slots "
          "freed by earlier completions (one shared decode step).")
    return out


if __name__ == "__main__":
    main()
