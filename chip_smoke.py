#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs a CUDA device and the repository's ``src/repro_torch`` beside this
file; it exits non-zero without either. Phases (each one fails the run):

  1. device   the card's name and power limit; TF32 off for matmuls and
              convolutions (the digital layers and the exact products
              stay float32-exact).
  2. build    every CUDA kernel of the port from ``src/repro_torch/
              kernels/csrc`` (nvcc, sm_90a, one process per source, all
              started together), with the build seconds, registers,
              static shared memory and spills per kernel entry; a spill
              fails the run, and so does a library whose SASS
              (cuobjdump, where one is found) has no IMMA, the tensor
              cores' integer MMA.
  3. kernel   each GPQ kernel (B1 gpq_matmul, B2 adder_tree_gpq_matmul,
              B3 cell_adc_gpq_matmul) against its plain PyTorch version
              on the card with ``torch.equal``: rows {4, 8, 16} x ADC
              bits {3, 4, 5} at cutoff 0.5 plus the step-12 point, floor
              and nearest, int8 codes and uint8 packed bytes, shapes that
              are not tile multiples, act_bits 8 with codes over the
              whole byte range, four points off the grid (cutoff 0.3, 6
              ADC bits, 6 and 12 rows) that take B1's and B3's other
              paths, 24 and 32 of 32 rows (two k16 steps per group), B2
              on an operand whose group sums take every merged value at
              cutoffs 0.5, 0.25, 0.3, 0.35 and 0.4 (steps that are not
              whole, where float32 division and exact arithmetic part),
              and the ResNet's own 14 operands at batch 256, on which B3
              must also equal B1. Then each depth guard must raise.
  4. slice    slice 1's path: the committed ResNet checkpoint (widths
              16/32/64, two blocks per stage), planned under the paper
              policy, on 4 batches of 256 synthetic eval images under fp,
              cim-exact and cim-kernel; B1's launch count over the
              cim-kernel run must be 14 per forward with only explicit
              ("p8t", "cuda") dispatches; the same batches under the scan
              twin on the card must give identical logits; the card's
              cim-kernel logits must agree with the port's CPU path on 8
              images.
     profile  one cim-kernel forward at batch 256 under torch.profiler:
              the top 10 device ops by total time and the device's busy
              share of the window (reported, never failed: a trace
              without device times says so).
  5. variants slice 2's path: for each saved calibration result in
              ``results/calibration/`` (p8t, adder-tree, cell-adc), load
              it, register it as the "analog" backend and run the same
              batches under cim-kernel: exactly 14 (variant, "cuda",
              "heuristic") dispatches per forward, the variant's kernel
              launched 14 times per forward, logits equal to the same
              result's scan twin (mode cim); the cell-adc logits must
              equal the p8t result's, and those slice 1's cim-kernel
              logits; the card against the CPU path on 8 images.
  6. timings  each of the ResNet's 14 kernel operands at batch 256, for
              each kernel: its time over 10 back-to-back wrapper calls
              (CUDA events around 10 calls, median of 5 windows, after
              warm-up; the host's share of short launches included),
              the report's ``ms``; its device time (10 launches in one
              CUDA graph, CUDA events around 5 replays, median), the
              report's ``device_ms``; and the plain version's, timed as
              ``ms``, beside the bound
              max(bytes / 3.35 TB/s, MAC ops / 1979 TOP/s int8). Each is
              timed again at cutoff 0.3, a step that is not a whole
              number of pMACs (B1's code table, B3's scaled search; B2
              has one conversion path).
  7. report   one JSON line listing every kernel of the port.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import pathlib
import re
import shutil
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
CALIBRATION_DIR = ROOT / "results" / "calibration"


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    variant: str
    replaces: str  # the TPU kernel, file:line
    per_plane: bool  # weight_bits plane MACs per weight MAC, else one
    guard_k: int  # the smallest K its depth guard refuses (paper point)

    def wrapper(self):
        from repro_torch.kernels import cim_mac

        return getattr(cim_mac, self.name)

    def plain(self):
        from repro_torch.kernels import cim_mac

        return getattr(cim_mac, f"{self.name}_plain")


KERNELS = (
    Kernel("gpq_matmul", "p8t", "src/repro/kernels/cim_mac.py:280", True,
           4096 * 16),
    Kernel("adder_tree_gpq_matmul", "adder-tree",
           "src/repro/kernels/cim_mac.py:331", False, 8192 * 16),
    Kernel("cell_adc_gpq_matmul", "cell-adc",
           "src/repro/kernels/cim_mac.py:386", True, 4096 * 16),
)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, windows: int = 5, per_window: int = 10,
                 warmup: int = 3) -> float:
    """Time per call: the median over ``windows`` CUDA-event windows of
    ``per_window`` back-to-back calls each, after warm-up. A launch
    shorter than the caller's host work per call is timed at that host
    work (``graph_time_ms`` leaves it out)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_window):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_window)
    return statistics.median(times)


def graph_time_ms(fn, reps: int = 10, windows: int = 5) -> float:
    """Device time per launch without the caller's host work: ``reps``
    launches captured in one CUDA graph, replayed ``windows`` times under
    CUDA events; the median window over ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (builds, binds) off the graph
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(windows):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    del graph
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


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    r = subprocess.run([tool], input="\n".join(names), capture_output=True,
                       text=True, timeout=60)
    out = r.stdout.splitlines()
    return out if r.returncode == 0 and len(out) == len(names) else names


def ptxas_entries(out: str) -> list[dict]:
    """Per kernel entry in nvcc's -Xptxas -v output: its name, the
    registers / shared-memory line and the spill bytes."""
    entries = []
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entries.append({"entry": line.split("'")[1], "used": "",
                            "spill": (0, 0)})
        elif entries and "spill stores" in line:
            entries[-1]["spill"] = tuple(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif entries and "Used" in line and "registers" in line:
            entries[-1]["used"] = line.split(":", 1)[1].strip()
    for e, name in zip(entries, demangle([e["entry"] for e in entries])):
        e["entry"] = name
    return entries


def find_cuobjdump() -> str | None:
    cands = [pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
             / "bin" / "cuobjdump", pathlib.Path("/usr/local/cuda/bin/cuobjdump")]
    found = shutil.which("cuobjdump")
    if found:
        cands.append(pathlib.Path(found))
    try:
        import triton

        cands.append(pathlib.Path(triton.__file__).parent / "backends"
                     / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in cands:
        if c.is_file():
            return str(c)
    return None


SASS_OPS = ("IMMA", "LDGSTS", "LDS", "PRMT", "VIMNMX", "ISETP", "SEL",
            "IMAD", "LOP3", "SHF")


def sass_counts(tool: str, lib: pathlib.Path) -> collections.Counter:
    """Opcode counts (before the first '.') of a library's SASS."""
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300, check=True)
    ops = collections.Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         r.stdout):
        ops[m.group(1)] += 1
    return ops


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel(s) in {secs:.1f} s")
    spills = []
    for name, (s, out) in sorted(build.BUILD_LOG.items()):
        log(f"[build] {name}: nvcc {s:.1f} s")
        for e in ptxas_entries(out):
            log(f"[build]   {e['entry'][:110]}: {e['used']}; spill "
                f"stores/loads {e['spill']} bytes")
            if any(e["spill"]):
                spills.append((name, e["entry"], e["spill"]))
    if spills:
        raise AssertionError(f"register spills in the kernels: {spills}")
    log(f"[build] no register spills in {', '.join(sorted(libs))}")
    tool = find_cuobjdump()
    if tool is None:
        log("[build] no cuobjdump found (toolkit or triton's bundled one): "
            "the SASS is not inspected; the inline PTX mma.sync ... u8.u8 "
            "in csrc/ptx.cuh is the evidence of tensor-core MMA")
        return
    for name, lib in sorted(libs.items()):
        ops = sass_counts(tool, lib)
        log(f"[build] {name} SASS ({tool}): {sum(ops.values())} "
            f"instructions; " + ", ".join(f"{op} {ops[op]}"
                                          for op in SASS_OPS))
        if ops["IMMA"] == 0:
            raise AssertionError(f"{name}: no IMMA in its SASS")


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


def merged_range_operand(cfg):
    """x [T, rows], w [rows, 4] (one row group) whose column-0 group sums
    take every merged value in [m_min, m_max] of cfg once: w[:, 0] =
    (-128, 127, 1, 0, ...), and target t is -128 a + 127 b + c with
    byte codes (the kernels read codes as bytes; at act_bits 4 the
    targets near the range's ends are no sum of 4-bit codes). The other
    columns are random, over random codes in x[:, 3:]."""
    import torch

    from repro_torch.core.variants import merged_quant

    mq = merged_quant(cfg)
    rows = cfg.rows_active
    gen = torch.Generator().manual_seed(1)
    t = torch.arange(mq.m_min, mq.m_max + 1, dtype=torch.int64)
    a = torch.where(t < 0, (127 - t) // 128, 0)
    b = torch.where(t < 0, 0, t // 127)
    c = t + 128 * a - 127 * b
    x = torch.randint(0, 16, (len(t), rows), generator=gen,
                      dtype=torch.int32)
    x[:, 0], x[:, 1], x[:, 2] = a, b, c
    w = torch.randint(-128, 128, (rows, 4), generator=gen,
                      dtype=torch.int8)
    w[:, 0] = 0
    w[:3, 0] = torch.tensor([-128, 127, 1], dtype=torch.int8)
    merged = x.to(torch.int64) @ w.to(torch.int64)
    if int(x.max()) > 255 or not torch.equal(merged[:, 0], t):
        raise AssertionError("the merged-range operand misses a value")
    return x.cuda(), w.cuda()


def phase_kernel(params, bn, images):
    import torch

    from repro_torch.core.params import CIMConfig

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {k.name: 0.0 for k in KERNELS}
    checks = 0

    def check(kern, x, w, cfg, what, want=None):
        nonlocal checks
        want = kern.plain()(x, w, cfg) if want is None else want
        for ww in (w, w.view(torch.uint8)):
            got = kern.wrapper()(x, ww, cfg)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item() if got.numel() else 0.0
            max_err[kern.name] = max(max_err[kern.name], err)
            checks += 1
            if not torch.equal(got, want):
                raise AssertionError(f"{kern.name} != plain at {what} "
                                     f"({ww.dtype}): max |err| {err}")
        return want

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
                for kern in KERNELS:
                    check(kern, x, w, cfg, f"{kw} {mode} {(m, k, n)}")
    # act_bits = 8: codes over the whole byte range, the kernels' unsigned
    # A operand at its edge (rows of 255 against all-ones weights reach the
    # largest pMAC, 16 * 255).
    for mode in ("floor", "nearest"):
        cfg = CIMConfig(adc_mode=mode, act_bits=8)
        for m, k, n in ((257, 144, 16), (130, 288, 40)):
            x = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32)
            w = torch.randint(-128, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
            x[:3] = 255
            w[:16, :4] = -1
            for kern in KERNELS:
                check(kern, x, w, cfg, f"act_bits 8 {mode} {(m, k, n)}")
    # Off the grid: a step that is not a whole number of pMACs (B1's code
    # table, B3's scaled search), 6 ADC bits (B3's run-time step count), 6
    # rows (x copied 4 bytes at a time) and 12 rows (a group short of 16
    # slots).
    for kw in (dict(cutoff=0.3), dict(adc_bits=6), dict(rows_active=6),
               dict(rows_active=12)):
        for mode in ("floor", "nearest"):
            cfg = CIMConfig(adc_mode=mode, **kw)
            for m, k, n in ((300, 17, 70), (1000, 144, 16)):
                x = torch.randint(0, 16, (m, k), generator=gen,
                                  device="cuda", dtype=torch.int32)
                w = torch.randint(-128, 128, (k, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
                for kern in KERNELS:
                    check(kern, x, w, cfg, f"{kw} {mode} {(m, k, n)}")
    # Groups of 24 and 32 rows: two chained k16 steps per group (a ring of
    # two groups, 32 weight slots per group), codes by B1's table and B3's
    # scaled search (a group's sum does not fit a 16-bit half there).
    for kw in (dict(rows_per_group=32, rows_active=24),
               dict(rows_per_group=32, rows_active=32)):
        for mode in ("floor", "nearest"):
            cfg = CIMConfig(adc_mode=mode, **kw)
            for m, k, n in ((37, 100, 21), (300, 17, 70), (513, 288, 33),
                            (4099, 32, 64)):
                x = torch.randint(0, 16, (m, k), generator=gen,
                                  device="cuda", dtype=torch.int32)
                w = torch.randint(-128, 128, (k, n), generator=gen,
                                  device="cuda", dtype=torch.int8)
                for kern in KERNELS:
                    check(kern, x, w, cfg, f"{kw} {mode} {(m, k, n)}")
    b1, b2, b3 = KERNELS
    x, w = merged_range_operand(CIMConfig())
    for cutoff in (0.5, 0.25, 0.3, 0.35, 0.4):
        for mode in ("floor", "nearest"):
            check(b2, x, w, CIMConfig(adc_mode=mode, cutoff=cutoff),
                  f"every merged value, cutoff {cutoff} {mode}")
    ops, spec = resnet_operands(params, bn, images)
    if len(ops) != MACRO_CONVS:
        raise AssertionError(f"{len(ops)} macro convs, want {MACRO_CONVS}")
    for mode in ("floor", "nearest"):
        cfg = spec.replace(adc_mode=mode)
        for name, x, w in ops:
            what = f"{name} {tuple(x.shape)}x{tuple(w.shape)} {mode}"
            want_b1 = check(b1, x, w, cfg, what)
            check(b2, x, w, cfg, what)
            # B3's plain version must give B1's, and the kernel both.
            want_b3 = b3.plain()(x, w, cfg)
            if not torch.equal(want_b3, want_b1):
                raise AssertionError(f"B3 plain != B1 plain at {what}")
            check(b3, x, w, cfg, what, want=want_b3)
            del want_b1, want_b3
    for kern in KERNELS:
        k = kern.guard_k
        try:
            kern.wrapper()(
                torch.zeros((1, k), dtype=torch.int32, device="cuda"),
                torch.zeros((k, 1), dtype=torch.int8, device="cuda"), spec)
        except ValueError as e:
            log(f"[kernel] {kern.name} depth guard raises at K={k}: {e}")
        else:
            raise AssertionError(f"{kern.name} depth guard did not raise "
                                 f"at K={k}")
        # One row group less passes.
        kern.wrapper()(
            torch.zeros((1, k - 16), dtype=torch.int32, device="cuda"),
            torch.zeros((k - 16, 1), dtype=torch.int8, device="cuda"), spec)
    torch.cuda.synchronize()
    log(f"[kernel] every kernel == its plain version (torch.equal) on "
        f"{checks} cases; B3 == B1 on the {MACRO_CONVS} ResNet operands; "
        f"max |err| {max_err}")
    return ops, spec, max_err


def eval_mode(params, bn, batches, mode, backend=""):
    import torch

    from repro_torch.configs import resnet as rcfg
    from repro_torch.models import resnet

    policy = dataclasses.replace(rcfg.cim_policy(mode=mode), backend=backend)
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


def card_vs_cpu(params, bn, img, mode, backend=""):
    """The card's logits against the port's CPU path (the kernels' plain
    versions) on a few images: the digital layers sum in another order
    (cuDNN vs CPU), so logits agree to 2e-2 (they are O(10)) with the same
    argmax."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import resnet as rcfg
    from repro_torch.models import resnet

    policy = dataclasses.replace(rcfg.cim_policy(mode=mode), backend=backend)
    cfg = dataclasses.replace(rcfg.RESNET_CFG, cim=policy)
    with torch.no_grad():
        dev, _ = resnet.forward(resnet.plan_params(params, policy), bn, img,
                                cfg)
        host, _ = resnet.forward(
            resnet.plan_params(convert.to_torch(params, device="cpu"),
                               policy),
            convert.to_torch(bn, device="cpu"), img.cpu(), cfg)
    diff = (dev.cpu() - host).abs().max().item()
    same = torch.equal(dev.cpu().argmax(-1), host.argmax(-1))
    if diff > 2e-2 or not same:
        raise AssertionError(f"card and CPU paths disagree ({mode} "
                             f"{backend}): {diff}, same top-1 {same}")
    return diff


def phase_slice(params, bn, batches):
    import torch

    from repro_torch.kernels import cim_mac, dispatch

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
    diff = card_vs_cpu(params, bn, batches[0][0][:8], "cim-kernel")
    log(f"[slice] card vs CPU path on 8 images: max |dlogit| {diff:.3g}, "
        f"same top-1: True")
    return launches, kern_logits


def phase_profile(params, bn, images):
    """One cim-kernel forward at batch 256 under torch.profiler: the top 10
    device ops by total time and the device's busy share of the window.
    A trace without device times is reported, not failed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import resnet as rcfg
    from repro_torch.models import resnet

    policy = rcfg.cim_policy(mode="cim-kernel")
    cfg = dataclasses.replace(rcfg.RESNET_CFG, cim=policy)
    planned = resnet.plan_params(params, policy)
    with torch.no_grad():
        resnet.forward(planned, bn, images, cfg)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            resnet.forward(planned, bn, images, cfg)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():  # device-side events: kernels, copies
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"[profile] no device time in the trace's key_averages() "
            f"({window_ms:.2f} ms window): not attributed")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] one cim-kernel forward at batch {len(images)}: "
        f"{window_ms:.3f} ms window (host clock), device busy "
        f"{busy:.3f} ms = {100 * busy / window_ms:.1f}% of it; top 10 "
        f"device ops by total time:")
    for ms, count, key in rows[:10]:
        log(f"[profile]   {ms:9.4f} ms {100 * ms / busy:5.1f}% x{count:<4d} "
            f"{key[:100]}")


def phase_variants(params, bn, batches, slice1_logits):
    """Slice 2: each saved calibration result through the kernels."""
    import torch

    from repro_torch.core import calibrate
    from repro_torch.kernels import cim_mac, dispatch

    launches, logits = {}, {}
    want = MACRO_CONVS * len(batches)
    for kern in KERNELS:
        v = kern.variant
        res = calibrate.load_result(
            CALIBRATION_DIR / f"resnet_paper_{v}.json")
        if {lc.variant for lc in res.layers.values()} != {v} or \
                len(res.layers) != MACRO_CONVS:
            raise AssertionError(f"{v}: unexpected calibration result")
        res.register("analog", overwrite=True)
        cim_mac.LAUNCHES.clear()
        with dispatch.record_resolutions() as log_k:
            lk, top1, ips = eval_mode(params, bn, batches, "cim-kernel",
                                      backend="analog")
        launches[kern.name] = cim_mac.LAUNCHES[kern.name]
        other = sum(cim_mac.LAUNCHES.values()) - launches[kern.name]
        kinds = collections.Counter(
            (r.key.variant, r.key.backend, r.source) for r in log_k)
        if kinds != {(v, "cuda", "heuristic"): want}:
            raise AssertionError(f"{v}: resolutions {dict(kinds)}, want "
                                 f"{want} ({v}, cuda, heuristic)")
        if launches[kern.name] != want or other:
            raise AssertionError(
                f"{v}: {kern.name} launched {launches[kern.name]} times "
                f"(other kernels {other}) over {len(batches)} forwards, "
                f"want {want}")
        with dispatch.record_resolutions() as log_s:
            ls, top1_s, ips_s = eval_mode(params, bn, batches, "cim",
                                          backend="analog")
        kinds = {(r.key.variant, r.key.backend, r.source) for r in log_s}
        if kinds != {(v, "scan", "heuristic")}:
            raise AssertionError(f"{v}: cim did not run the scan twin: "
                                 f"{kinds}")
        if not torch.equal(lk, ls):
            d = (lk - ls).abs().max().item()
            raise AssertionError(f"{v}: cim-kernel logits != scan ({d})")
        diff = card_vs_cpu(params, bn, batches[0][0][:8], "cim-kernel",
                           backend="analog")
        logits[v] = lk
        log(f"[variants] {v:10s} top-1 {top1:.4f} over "
            f"{len(batches) * BATCH} images; cim-kernel {ips:.1f} "
            f"images/s, scan twin {ips_s:.1f} images/s; {kern.name} "
            f"launched {launches[kern.name]} times ({want // len(batches)} "
            f"per forward); logits == scan twin; card vs CPU on 8 images "
            f"max |dlogit| {diff:.3g}")
    if not torch.equal(logits["cell-adc"], logits["p8t"]):
        raise AssertionError("cell-adc logits != p8t logits")
    if not torch.equal(logits["p8t"], slice1_logits):
        raise AssertionError("p8t calibrated logits != slice 1 cim-kernel")
    log("[variants] cell-adc logits == p8t logits == slice 1 cim-kernel "
        "logits")
    return launches


def phase_timings(ops, spec):
    """Per kernel, one forward's 14 launches summed: (ms over back-to-back
    wrapper calls, plain ms, bound ms, bound_by, device ms in a graph)."""
    rows = {}
    for kern in KERNELS:
        per_op = []
        for name, x, w in ops:
            m, k = x.shape
            n = w.shape[1]
            ms = cuda_time_ms(
                lambda x=x, w=w, f=kern.wrapper(): f(x, w, spec))
            device_ms = graph_time_ms(
                lambda x=x, w=w, f=kern.wrapper(): f(x, w, spec))
            plain_ms = cuda_time_ms(
                lambda x=x, w=w, f=kern.plain(): f(x, w, spec))
            nbytes = (m * k * x.element_size() + k * n * w.element_size()
                      + m * n * 4)
            macs = m * k * n * (spec.weight_bits if kern.per_plane else 1)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * macs / INT8_OPS_PER_S * 1e3
            per_op.append((ms, plain_ms, max(bytes_ms, ops_ms), device_ms,
                           bytes_ms >= ops_ms))
            log(f"[timing] {kern.name:22s} {name:12s} [{m}, {k}]x[{k}, {n}]: "
                f"kernel {ms:.4f} ms over back-to-back wrapper calls "
                f"({device_ms:.4f} device ms in a graph), plain "
                f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
                f"{nbytes / 1e6:.1f} MB, {2 * macs / 1e9:.2f} G int8 "
                f"ops)")
        tot = [sum(r[i] for r in per_op) for i in range(4)]
        bound_by = ("bytes" if sum(r[4] for r in per_op) * 2 >= len(per_op)
                    else "operations")
        log(f"[timing] {kern.name}: one forward's {len(per_op)} launches: "
            f"kernel {tot[0]:.4f} ms over back-to-back wrapper calls "
            f"({tot[3]:.4f} device ms in a graph), plain {tot[1]:.4f} ms, "
            f"bound {tot[2]:.4f} ms ({bound_by}); library: none (no single "
            f"PyTorch call computes a GPQ transfer)")
        rows[kern.name] = (*tot[:3], bound_by, tot[3])
    # Off the grid: a step of 179 / 16 pMACs takes B1's shared-memory code
    # table and B3's scaled run-time search, one code per register; B2's
    # conversion is the same everywhere.
    off = spec.replace(cutoff=0.3)
    for kern in KERNELS:
        ms = sum(cuda_time_ms(lambda x=x, w=w, f=kern.wrapper(): f(x, w, off))
                 for _, x, w in ops)
        device_ms = sum(
            graph_time_ms(lambda x=x, w=w, f=kern.wrapper(): f(x, w, off))
            for _, x, w in ops)
        log(f"[timing] {kern.name} at cutoff 0.3 (off the grid): one "
            f"forward's {len(ops)} launches: {ms:.4f} ms over back-to-back "
            f"wrapper calls ({device_ms:.4f} device ms in a graph), against "
            f"{rows[kern.name][0]:.4f} ({rows[kern.name][4]:.4f}) at the "
            f"paper point")
    return rows


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
    _, slice1_logits = phase_slice(params, bn, batches)
    phase_profile(params, bn, batches[0][0])
    launches = phase_variants(params, bn, batches, slice1_logits)
    timings = phase_timings(ops, spec)

    report = {"kernels": [{
        "name": kern.name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{kern.name}.cu",
        "replaces": kern.replaces,
        "launches": launches[kern.name],
        "max_abs_err": max_err[kern.name],
        "ms": timings[kern.name][0],
        "device_ms": timings[kern.name][4],
        "plain_ms": timings[kern.name][1],
        "bound_ms": timings[kern.name][2],
        "bound_by": timings[kern.name][3],
        "library_ms": None,
    } for kern in KERNELS]}
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
