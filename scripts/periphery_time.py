"""The periphery kernels' times on the card against the ATen ops they
replace, and the single-block threshold's sweep.

    PYTHONPATH=src python3 scripts/periphery_time.py [--out <file.json>]

Prints one JSON line per measurement (and writes them all to ``--out``):

  quantize    ``periphery.quantize_acts`` of x [M, K] in each design
              (``single``: one block ranges and codes; ``two-pass``:
              partial ranges, then every block codes its slice;
              ``percentile``: the range from ``quant.percentile``, one
              launch) beside ``quant.quantize_acts``' ATen ops (``aten``)
              and the plain version (``plain``)
  epilogue    ``periphery.dequant_epilogue`` over y [M, N] beside the
              engine's ATen epilogue and the plain version

with ``device_us`` (a CUDA graph of 20 calls replayed, per call; the
calls cycle over copies of the inputs that together pass 200 MB, so a
large input is read cold from HBM as the bound counts it, while a small
one stays in L2, as it does behind the op that wrote it), ``eager_us``
(200 calls back to back from the host, synchronised at the end, per
call: what an eager caller waits), the bytes the call must move (each
input read once, each output written once) and ``bound_us`` at 3.35
TB/s. Every result is checked bit for bit against the ATen ops first.
It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from repro_torch.core import quant
from repro_torch.kernels import build, periphery

HBM_BPS = 3.35e12
COLD_BYTES = 200e6
# (M, K) of the quantizer's sweep: a granite expert (M = 4, K = 1024), then
# growing M over the single-block threshold, and the qwen2 prefill's
# projections (M = 4096, K = 896 and 4864).
QUANT_SHAPES = [(1, 1024), (4, 1024), (8, 1024), (4, 4864), (16, 1024),
                (32, 1024), (64, 1024), (512, 1024), (4096, 896),
                (4096, 4864)]
# (M, N) of the epilogue: granite expert up/gate and down, a qwen2 decode
# MLP up, the prefill's down projection and its MLP up.
EPI_SHAPES = [(4, 512), (4, 1024), (4, 4864), (4096, 896), (4096, 4864)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def copies(t: torch.Tensor) -> list[torch.Tensor]:
    """t and clones of it, enough to pass COLD_BYTES (at most 64)."""
    c = min(64, max(1, math.ceil(COLD_BYTES / (t.numel() * t.element_size()))))
    return [t] + [t.clone() for _ in range(c - 1)]


def graph_us(fn, reps=20) -> float:
    """Device us per call: ``fn(i)`` for i < reps captured in one graph,
    the best of five replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(5):
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e3 / reps)
    del g
    torch.cuda.empty_cache()
    return best


def eager_us(fn, reps=200) -> float:
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _row(out, **kw):
    out.append(kw)
    print(json.dumps(kw), flush=True)


def quantize_rows(out):
    for (m, k), (dname, dt) in [(s, d) for s in QUANT_SHAPES
                                for d in DTYPES.items()]:
        gen = torch.Generator(device="cuda").manual_seed(m * k)
        x = (torch.randn((m, k), generator=gen, device="cuda") * 3
             + 0.7).to(dt)
        xs = copies(x)
        n = m * k
        nbytes = n * x.element_size() + 4 * n
        designs = {"single": (1 << 62, 1.0), "two-pass": (0, 1.0),
                   "percentile": (periphery.SINGLE_BLOCK_MAX, 0.995)}
        for design, (threshold, clip) in designs.items():
            if design == "single" and n > 1 << 20:
                continue  # one block over a prefill activation: no design

            def fn(i, threshold=threshold, clip=clip):
                periphery.SINGLE_BLOCK_MAX = threshold
                return periphery.quantize_acts(xs[i % len(xs)], 4,
                                               clip_pct=clip)

            keep = periphery.SINGLE_BLOCK_MAX
            try:
                if not _same(fn(0), quant.quantize_acts(x, 4, clip_pct=clip)):
                    raise AssertionError(f"{design} {m}x{k} {dname}: != ATen")
                # The percentile reads its position on the host: no graph.
                dev = graph_us(fn) if clip == 1.0 else None
                eag = eager_us(fn)
            finally:
                periphery.SINGLE_BLOCK_MAX = keep
            _row(out, kind="quantize", design=design, m=m, k=k, dtype=dname,
                 device_us=dev, eager_us=eag, bytes=nbytes,
                 bound_us=nbytes / HBM_BPS * 1e6)
        for name, f in (("aten", quant.quantize_acts),
                        ("plain", periphery.quantize_acts_plain)):
            def ref(i, f=f):
                return f(xs[i % len(xs)], 4)
            _row(out, kind="quantize", design=name, m=m, k=k, dtype=dname,
                 device_us=graph_us(ref), eager_us=eager_us(ref))


def epilogue_rows(out):
    for (m, n), (dname, dt) in [(s, d) for s in EPI_SHAPES
                                for d in DTYPES.items()]:
        gen = torch.Generator(device="cuda").manual_seed(m + n)
        qa = quant.quantize_acts(torch.randn((4, 64), generator=gen,
                                             device="cuda").to(dt), 4)
        colsum = torch.randint(-2000, 2000, (1, n), generator=gen,
                               device="cuda").to(torch.float32)
        wscale = torch.rand((1, n), generator=gen, device="cuda") * 1e-3
        ys = copies(torch.randint(-5000, 5000, (m, n), generator=gen,
                                  device="cuda").to(torch.float32))

        def aten(i):
            y = ys[i % len(ys)] - qa.zero_point.to(torch.float32) * colsum
            return (y * qa.scale * wscale).to(dt)

        fns = {
            "kernel": lambda i: periphery.dequant_epilogue(
                ys[i % len(ys)], qa, colsum, wscale, dt),
            "aten": aten,
            "plain": lambda i: periphery.dequant_epilogue_plain(
                ys[i % len(ys)], qa, colsum, wscale, dt),
        }
        if not torch.equal(fns["kernel"](0), aten(0)):
            raise AssertionError(f"epilogue {m}x{n} {dname}: != ATen")
        nbytes = (4 + torch.finfo(dt).bits // 8) * m * n + 8 * n
        for design, fn in fns.items():
            _row(out, kind="epilogue", design=design, m=m, n=n, dtype=dname,
                 device_us=graph_us(fn), eager_us=eager_us(fn), bytes=nbytes,
                 bound_us=nbytes / HBM_BPS * 1e6)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all([periphery.SOURCE])
    secs, log = build.BUILD_LOG.get(periphery.SOURCE, (0.0, "cached"))
    print(json.dumps(dict(card=card, torch=torch.__version__,
                          build_s=secs, ptxas=log[-4000:])), flush=True)
    out: list[dict] = []
    quantize_rows(out)
    epilogue_rows(out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=out), f, indent=1)


if __name__ == "__main__":
    main()
