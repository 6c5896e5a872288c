#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs a CUDA device and the repository's ``src/repro_torch`` beside this
file; it exits non-zero without either. Phases (each one fails the run):

  1. device   the card's name and power limit; TF32 off for matmuls and
              convolutions (the digital layers and the exact products
              stay float32-exact).
  2. build    every CUDA kernel of the port from ``src/repro_torch/
              kernels/csrc`` (nvcc, sm_90a), with the build seconds.
  3. kernel   the GPQ kernel against its plain PyTorch version on the
              card with ``torch.equal``: rows {4, 8, 16} x ADC bits
              {3, 4, 5} at cutoff 0.5 plus the step-12 point, floor and
              nearest, int8 codes and uint8 packed bytes, shapes that are
              not tile multiples, and the ResNet's own operands at batch
              256. Then the depth guard must raise.
  4. slice    the committed ResNet checkpoint (widths 16/32/64, two
              blocks per stage), planned under the paper policy, on 4
              batches of 256 synthetic eval images under fp, cim-exact
              and cim-kernel; the kernel's launch count over the
              cim-kernel run must be 14 per forward with only explicit
              ("p8t", "cuda") dispatches; the same batches under the
              scan twin on the card must give identical logits; the
              card's cim-kernel logits must agree with the port's CPU
              path on 8 images.
  5. timings  each of the ResNet's kernel operands at batch 256: kernel
              and plain-version times (CUDA events, median of 25 after
              warm-up) beside the bound max(bytes / 3.35 TB/s,
              plane-MAC ops / 1979 TOP/s int8); whole-forward images/s.
  6. report   one JSON line listing every kernel of the port.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
BATCH = 256
N_BATCHES = 4
MACRO_CONVS = 14  # per forward: stem and fc stay digital


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is false)")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"chip_smoke.py needs the repository's src/repro_torch: {e}"
        ) from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    line = card_line()
    log(f"[device] {line}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return line


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel(s) in {secs:.1f} s")
    for name, (s, out) in sorted(build.BUILD_LOG.items()):
        log(f"[build] {name}: nvcc {s:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def resnet_operands(params, bn, images):
    """The 14 (x_codes, w_codes, spec) operands the kernel gets in one
    cim-kernel forward, captured through the model's tap hook."""
    import torch

    from repro_torch.configs import resnet as rcfg
    from repro_torch.core import quant
    from repro_torch.models import resnet

    policy = rcfg.cim_policy(mode="cim-kernel")
    cfg = dataclasses.replace(rcfg.RESNET_CFG, cim=policy)
    planned = resnet.plan_params(params, policy)
    ops = []

    def tap(name, x2, plan):
        qa = quant.quantize_acts(x2, policy.cim.act_bits,
                                 symmetric=policy.act_symmetric,
                                 clip_pct=policy.act_clip_pct)
        ops.append((name, qa.codes, plan.codes))

    with torch.no_grad():
        resnet.forward(planned, bn, images, cfg, tap=tap)
    return ops, policy.cim


def phase_kernel(params, bn, images):
    import torch

    from repro_torch.core.params import CIMConfig
    from repro_torch.kernels import cim_mac

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    checks = 0

    def check(x, w, cfg, what):
        nonlocal max_err, checks
        want = cim_mac.gpq_matmul_plain(x, w, cfg)
        for ww in (w, w.view(torch.uint8)):
            got = cim_mac.gpq_matmul(x, ww, cfg)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item() if got.numel() else 0.0
            max_err = max(max_err, err)
            checks += 1
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain at {what} "
                                     f"({ww.dtype}): max |err| {err}")

    grid = [dict(rows_active=r, adc_bits=a, cutoff=0.5)
            for r in (4, 8, 16) for a in (3, 4, 5)]
    grid.append(dict(rows_active=16, adc_bits=4, cutoff=0.25))  # step 12
    shapes = [(1, 16, 1), (37, 100, 21), (300, 17, 70), (1000, 144, 16),
              (513, 288, 33), (130, 576, 64), (4099, 32, 64)]
    for kw in grid:
        for mode in ("floor", "nearest"):
            cfg = CIMConfig(adc_mode=mode, **kw)
            for m, k, n in shapes:
                x = torch.randint(0, 16, (m, k), generator=gen,
                                  device="cuda", dtype=torch.int32)
                w = torch.randint(-128, 128, (k, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
                check(x, w, cfg, f"{kw} {mode} {(m, k, n)}")
    ops, spec = resnet_operands(params, bn, images)
    if len(ops) != MACRO_CONVS:
        raise AssertionError(f"{len(ops)} macro convs, want {MACRO_CONVS}")
    for mode in ("floor", "nearest"):
        cfg = spec.replace(adc_mode=mode)
        for name, x, w in ops:
            check(x, w, cfg, f"{name} {tuple(x.shape)}x{tuple(w.shape)} "
                  f"{mode}")
    k = 4096 * 16
    try:
        cim_mac.gpq_matmul(torch.zeros((1, k), dtype=torch.int32,
                                       device="cuda"),
                           torch.zeros((k, 1), dtype=torch.int8,
                                       device="cuda"), spec)
    except ValueError as e:
        log(f"[kernel] depth guard raises: {e}")
    else:
        raise AssertionError("depth guard did not raise at K=65536")
    log(f"[kernel] gpq_matmul == plain (torch.equal) on {checks} cases; "
        f"max |err| {max_err}")
    return ops, spec, max_err


def eval_mode(params, bn, batches, mode):
    import torch

    from repro_torch.configs import resnet as rcfg
    from repro_torch.models import resnet

    policy = rcfg.cim_policy(mode=mode)
    cfg = dataclasses.replace(rcfg.RESNET_CFG, cim=policy)
    p = params if mode == "fp" else resnet.plan_params(params, policy)
    logits = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for img, _ in batches:
            out, _ = resnet.forward(p, bn, img, cfg)
            logits.append(out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    logits = torch.cat(logits)
    labels = torch.cat([lab for _, lab in batches])
    top1 = (logits.argmax(-1) == labels).float().mean().item()
    if not (torch.isfinite(logits).all() and
            logits.shape == (len(batches) * BATCH, rcfg.N_CLASSES)):
        raise AssertionError(f"{mode}: bad logits {tuple(logits.shape)}")
    return logits, top1, len(logits) / secs


def phase_slice(params, bn, batches):
    import torch

    from repro_torch import convert
    from repro_torch.configs import resnet as rcfg
    from repro_torch.kernels import cim_mac, dispatch
    from repro_torch.models import resnet

    results = {}
    for mode in ("fp", "cim-exact"):
        _, top1, ips = eval_mode(params, bn, batches, mode)
        results[mode] = (top1, ips)
    cim_mac.LAUNCHES.clear()
    with dispatch.record_resolutions() as res:
        kern_logits, top1, ips = eval_mode(params, bn, batches, "cim-kernel")
    launches = cim_mac.LAUNCHES["gpq_matmul"]
    results["cim-kernel"] = (top1, ips)
    want = MACRO_CONVS * len(batches)
    if launches != want:
        raise AssertionError(f"gpq_matmul launched {launches} times over "
                             f"{len(batches)} forwards, want {want}")
    kinds = {(r.key.variant, r.key.backend, r.source) for r in res}
    if kinds != {("p8t", "cuda", "explicit")} or len(res) != want:
        raise AssertionError(f"unexpected resolutions: {sorted(kinds)}")
    with dispatch.record_resolutions() as res:
        scan_logits, top1, ips = eval_mode(params, bn, batches, "cim")
    results["cim (scan twin)"] = (top1, ips)
    kinds = {(r.key.variant, r.key.backend, r.source) for r in res}
    if kinds != {("p8t", "scan", "heuristic")}:
        raise AssertionError(f"cim did not run the scan twin: {kinds}")
    if not torch.equal(kern_logits, scan_logits):
        d = (kern_logits - scan_logits).abs().max().item()
        raise AssertionError(f"cim-kernel logits != scan logits ({d})")
    for mode, (top1, ips) in results.items():
        log(f"[slice] {mode:16s} top-1 {top1:.4f} over "
            f"{len(batches) * BATCH} images, {ips:.1f} images/s")
    if results["fp"][0] < 0.9 or results["cim-exact"][0] < 0.9:
        raise AssertionError(f"fp/cim-exact top-1 below 0.9: {results}")

    # The card against the port's CPU path (plain kernel version) on 8
    # images: the digital layers sum in another order (cuDNN vs CPU), so
    # logits agree to 2e-2 (they are O(10)) with the same argmax.
    policy = rcfg.cim_policy(mode="cim-kernel")
    cfg = dataclasses.replace(rcfg.RESNET_CFG, cim=policy)
    img = batches[0][0][:8]
    with torch.no_grad():
        dev, _ = resnet.forward(resnet.plan_params(params, policy), bn, img,
                                cfg)
        host, _ = resnet.forward(
            resnet.plan_params(convert.to_torch(params, device="cpu"),
                               policy),
            convert.to_torch(bn, device="cpu"), img.cpu(), cfg)
    diff = (dev.cpu() - host).abs().max().item()
    same = torch.equal(dev.cpu().argmax(-1), host.argmax(-1))
    log(f"[slice] card vs CPU path on 8 images: max |dlogit| {diff:.3g}, "
        f"same top-1: {same}")
    if diff > 2e-2 or not same:
        raise AssertionError("card and CPU paths disagree")
    return launches


def phase_timings(ops, spec):
    from repro_torch.kernels import cim_mac

    rows = []
    for name, x, w in ops:
        m, k = x.shape
        n = w.shape[1]
        ms = cuda_time_ms(lambda x=x, w=w: cim_mac.gpq_matmul(x, w, spec))
        plain_ms = cuda_time_ms(
            lambda x=x, w=w: cim_mac.gpq_matmul_plain(x, w, spec))
        nbytes = m * k * x.element_size() + k * n * w.element_size() + m * n * 4
        ops_ = 2 * m * k * n * spec.weight_bits  # one MAC per plane bit
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_ / INT8_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        rows.append((ms, plain_ms, bound, bytes_ms >= ops_ms))
        log(f"[timing] {name:12s} [{m}, {k}]x[{k}, {n}]: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
            f"{nbytes / 1e6:.1f} MB, {ops_ / 1e9:.2f} G plane-MAC ops); "
            f"library: none (no single PyTorch call computes GPQ)")
    tot = [sum(r[i] for r in rows) for i in range(3)]
    log(f"[timing] one forward's 14 launches: kernel {tot[0]:.4f} ms, "
        f"plain {tot[1]:.4f} ms, bound {tot[2]:.4f} ms")
    bound_by = "bytes" if sum(r[3] for r in rows) * 2 >= len(rows) else \
        "operations"
    return tot, bound_by


def main() -> int:
    import torch

    card = phase_device()
    phase_build()

    from repro_torch.configs import resnet as rcfg

    params, bn = rcfg.load_baseline(device="cuda")
    ds = rcfg.dataset()
    batches = []
    for s in range(N_BATCHES):
        b = ds.batch(BATCH, step=s, train=False)
        batches.append((torch.from_numpy(b["image"]).cuda(),
                        torch.from_numpy(b["label"]).long().cuda()))

    ops, spec, max_err = phase_kernel(params, bn, batches[0][0])
    launches = phase_slice(params, bn, batches)
    (ms, plain_ms, bound_ms), bound_by = phase_timings(ops, spec)

    report = {"kernels": [{
        "name": "gpq_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gpq_matmul.cu",
        "replaces": "src/repro/kernels/cim_mac.py:280",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    log(json.dumps(report))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
