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
  7. lm       slice 3's path: qwen2-0.5b at its published widths and
              depth (24 layers, d_model 896, GQA 14/2 heads, d_ff 4864,
              vocab 151936; random weights from torch.Generator seed 0)
              under the paper policy (PAPER_OP_16ROWS). B1 == its plain
              version (torch.equal) on the 7 projections' operands with
              activation codes captured from the model at decode (M = 4)
              and prefill (M = 512), floor and nearest; the cim-kernel
              prefill and 8 decode steps with logits equal to the same
              steps with every macro matmul forced through the scan twin;
              168 ("p8t", "cuda") resolutions and B1 launches per decode
              step; the card against the port's CPU path at depth 2 (full
              width, float32 activations: bfloat16 logits tie), same
              tokens under fp and cim-kernel;
              ServeEngine.generate at batch 4, prompt 128 (MarkovLM), 32
              new tokens under fp (planned int8), cim-exact and cim-kernel
              (prefill ms, decode ms per step, tokens/s on the host clock,
              the first 9 cim-kernel tokens equal to the checked run's);
              examples/serve_cim.py's five requests through the
              ContinuousBatcher under cim-kernel; B1's time per launch at
              the 14 LM operands (as phase 6) beside its bound; one decode
              step under torch.profiler.
  8. report   one JSON line listing every kernel of the port and its
              launches on each path.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
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
LM_ARCH = "qwen2_0_5b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 128, 32
LM_SCAN_STEPS = 8  # decode steps held to the scan twin
LM_PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
LM_SCHEDULE = ((4, 6), (8, 4), (3, 8), (6, 5), (5, 7))  # serve_cim.py's


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
    # bfloat16 GEMMs reduce in float32, as the CPU path does.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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


def lm_cfg(mode: str, **kw):
    """qwen2-0.5b's published CONFIG under ``mode`` at the paper point."""
    from repro_torch.configs.base import CIMPolicy, get_config
    from repro_torch.core.params import PAPER_OP_16ROWS

    cfg = get_config(LM_ARCH)
    if mode != "fp":
        cfg = cfg.replace(cim=CIMPolicy(mode=mode, cim=PAPER_OP_16ROWS))
    return cfg.replace(**kw)


def scan_twin(cfg):
    """``cfg`` with every macro matmul through the scan twin: on a CUDA
    device the heuristic sends plans without unpacked planes (stacked LM
    plans have none) to B1, so the scan is requested explicitly, through
    an engine backend registered here."""
    from repro_torch.core import engine
    from repro_torch.kernels import dispatch

    if "scan-twin" not in engine.backend_names():
        engine.register_backend("scan-twin", engine.quantized_backend(
            lambda x, plan, spec, gen: dispatch.dispatch(
                x, plan.codes, spec, backend="scan", planes=plan.planes)))
    return cfg.replace(cim=dataclasses.replace(cfg.cim, mode="cim",
                                               backend="scan-twin"))


@contextlib.contextmanager
def capture_b1(n: int):
    """The first ``n`` (x codes, w codes) operands B1's wrapper gets."""
    from repro_torch.kernels import ops

    real = ops.cim_matmul_kernel
    got = []

    def rec(x, w, spec):
        if len(got) < n:
            got.append((x, w))
        return real(x, w, spec)

    ops.cim_matmul_kernel = rec
    try:
        yield got
    finally:
        ops.cim_matmul_kernel = real


def _tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    return tree.numel()


def lm_steps(params, cfg, prompts, steps: int, on_step=None):
    """Prefill, then ``steps`` greedy decode steps: the logits of each.
    ``on_step(i, fn)`` wraps each step (i = 0 is the prefill)."""
    import torch

    from repro_torch.models import transformer

    b, s = prompts.shape
    caches = transformer.init_caches(cfg, b, s + steps + 1, device="cuda")
    run = on_step or (lambda i, fn: fn())
    out = []
    with torch.no_grad():
        logits, _ = run(0, lambda: transformer.prefill(params, prompts,
                                                       caches, cfg))
        out.append(logits)
        for i in range(steps):
            tok = logits.argmax(-1)
            logits, _ = run(i + 1, lambda tok=tok, i=i: transformer.decode_step(
                params, tok, s + i, caches, cfg))
            out.append(logits)
    return out


def host_ms(fn):
    """(result, ms) of ``fn()`` on the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_lm():
    """Slice 3: qwen2-0.5b served through B1 (see the module docstring).
    Returns (launches, max |err|, timings) for the report."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import engine
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import cim_mac, dispatch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import (ContinuousBatcher, Request,
                                          ServeEngine)

    cfg_k = lm_cfg("cim-kernel")
    spec = cfg_k.cim.cim
    per_step = cfg_k.n_layers * len(LM_PROJECTIONS)
    t0 = time.perf_counter()
    params = transformer.init(0, cfg_k, device="cuda")
    planned = engine.plan_params(params, policy=cfg_k.cim)
    torch.cuda.synchronize()
    n = _tree_numel(params)
    want_n = (cfg_k.param_count()
              + (cfg_k.padded_vocab - cfg_k.vocab_size) * cfg_k.d_model)
    if n != want_n:
        raise AssertionError(f"{n} parameters, want {want_n}")
    log(f"[lm] {cfg_k.name}: {n / 1e6:.1f} M parameters (vocab padded to "
        f"{cfg_k.padded_vocab}), {cfg_k.n_layers} layers, initialised and "
        f"planned on the card in {time.perf_counter() - t0:.1f} s")
    prompts = torch.from_numpy(MarkovLM(cfg_k.vocab_size, seed=0).sample(
        LM_BATCH, LM_PROMPT - 1, seed=0)).long().cuda()

    # B1 against its plain version on the model's own operands.
    caches = transformer.init_caches(cfg_k, LM_BATCH, LM_PROMPT + 2,
                                     device="cuda")
    with torch.no_grad():
        with capture_b1(len(LM_PROJECTIONS)) as pre:
            logits, _ = transformer.prefill(planned, prompts, caches, cfg_k)
        with capture_b1(len(LM_PROJECTIONS)) as dec:
            transformer.decode_step(planned, logits.argmax(-1), LM_PROMPT,
                                    caches, cfg_k)
    ops = [(f"prefill {p}", x, w) for p, (x, w) in zip(LM_PROJECTIONS, pre)]
    ops += [(f"decode {p}", x, w) for p, (x, w) in zip(LM_PROJECTIONS, dec)]
    max_err = 0.0
    for name, x, w in ops:
        m = LM_BATCH * (LM_PROMPT if name.startswith("prefill") else 1)
        if x.shape[0] != m or x.dtype != torch.int32 or w.dtype != torch.int8:
            raise AssertionError(f"{name}: operand {tuple(x.shape)} "
                                 f"{x.dtype} x {tuple(w.shape)} {w.dtype}")
        for mode in ("floor", "nearest"):
            cfg = spec.replace(adc_mode=mode)
            want = cim_mac.gpq_matmul_plain(x, w, cfg)
            got = cim_mac.gpq_matmul(x, w, cfg)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"gpq_matmul != plain at LM {name} "
                                     f"{mode}: max |err| {err}")
    log(f"[lm] gpq_matmul == plain (torch.equal) on the {len(ops)} LM "
        f"operands, floor and nearest: " + ", ".join(
            f"{nm} [{x.shape[0]}, {x.shape[1]}]x[{w.shape[0]}, "
            f"{w.shape[1]}]" for nm, x, w in ops))

    # The kernel path against the scan twin, step by step.
    resolutions, launches = [], []

    def counted(i, fn):
        cim_mac.LAUNCHES.clear()
        with dispatch.record_resolutions() as res:
            out = fn()
        resolutions.append(collections.Counter(
            (r.key.variant, r.key.backend, r.source) for r in res))
        launches.append(cim_mac.LAUNCHES["gpq_matmul"])
        return out

    t0 = time.perf_counter()
    kern = lm_steps(planned, cfg_k, prompts, LM_SCAN_STEPS, counted)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    for i, (res, nl) in enumerate(zip(resolutions, launches)):
        if res != {("p8t", "cuda", "explicit"): per_step} or nl != per_step:
            raise AssertionError(f"step {i}: resolutions {dict(res)}, "
                                 f"{nl} B1 launches; want {per_step}")
    t0 = time.perf_counter()
    cfg_s = scan_twin(cfg_k)
    with dispatch.record_resolutions() as res:
        scan = lm_steps(planned, cfg_s, prompts, LM_SCAN_STEPS)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    kinds = {(r.key.variant, r.key.backend, r.source) for r in res}
    if kinds != {("p8t", "scan", "explicit")}:
        raise AssertionError(f"the scan twin ran {kinds}")
    for i, (a, b) in enumerate(zip(kern, scan)):
        if not (torch.equal(a, b) and torch.isfinite(a).all()):
            d = (a.float() - b.float()).abs().max().item()
            raise AssertionError(f"step {i}: cim-kernel logits != scan "
                                 f"twin's ({d})")
    kern_toks = torch.stack([lg.argmax(-1) for lg in kern], 1).cpu().numpy()
    log(f"[lm] prefill + {LM_SCAN_STEPS} decode steps: cim-kernel logits == "
        f"scan twin's (torch.equal) at every step; {per_step} explicit "
        f"(p8t, cuda) resolutions and {per_step} B1 launches per step "
        f"(prefill and each decode step); {t_kern:.1f} s through B1, "
        f"{t_scan:.1f} s through the scan")

    # The card against the port's CPU path, full width at depth 2, in
    # float32: bfloat16 logits of 152k random-weight tokens tie within one
    # bfloat16 step, so there the two sum orders pick different tokens.
    cfg2 = lm_cfg("fp", n_layers=2)
    p2 = transformer.init(0, cfg2, device="cuda")
    p2_cpu = convert.to_torch(p2, device="cpu")
    for mode in ("fp", "cim-kernel"):
        c2 = lm_cfg(mode, n_layers=2, activation_dtype="float32")
        kw = dict(max_len=LM_PROMPT + 9, batch=LM_BATCH, plan=mode != "fp")
        dev = ServeEngine(p2, c2, device="cuda", **kw).generate(prompts, 8)
        host = ServeEngine(p2_cpu, c2, device="cpu", **kw).generate(
            prompts.cpu(), 8)
        if not np.array_equal(dev, host):
            raise AssertionError(f"{mode}: card tokens {dev.tolist()} != "
                                 f"CPU tokens {host.tolist()} at depth 2")
        log(f"[lm] card == CPU path at depth 2, full width, float32 "
            f"activations, {mode}: the same 8 greedy tokens for each of "
            f"{LM_BATCH} prompts")
    del p2, p2_cpu

    # ServeEngine.generate per mode, on the host clock.
    gen_launches = 0
    for mode in ("fp", "cim-exact", "cim-kernel"):
        cfg = lm_cfg(mode)
        # fp plans int8 weight-only; the CIM modes serve the planned tree.
        eng = ServeEngine(planned if mode != "fp" else params, cfg,
                          max_len=LM_PROMPT + LM_GEN + 1, batch=LM_BATCH,
                          plan=mode == "fp")
        eng.generate(prompts, 2)  # warm
        cim_mac.LAUNCHES.clear()
        toks, total_ms = host_ms(lambda eng=eng: eng.generate(prompts,
                                                              LM_GEN))
        launched = cim_mac.LAUNCHES["gpq_matmul"]
        _, pre_ms = host_ms(lambda eng=eng: eng._prefill(prompts))
        dec_ms = (total_ms - pre_ms) / (LM_GEN - 1)
        if toks.shape != (LM_BATCH, LM_GEN) or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{mode}: bad tokens {toks.shape}")
        want = per_step * LM_GEN if mode == "cim-kernel" else 0
        if launched != want:
            raise AssertionError(f"{mode}: {launched} B1 launches in "
                                 f"generate, want {want}")
        if mode == "cim-kernel":
            gen_launches = launched
            if not np.array_equal(toks[:, :LM_SCAN_STEPS + 1], kern_toks):
                raise AssertionError("generate's tokens != the checked run's")
        log(f"[lm] generate {mode:10s} batch {LM_BATCH}, prompt {LM_PROMPT}, "
            f"{LM_GEN} new tokens: {total_ms:.2f} ms, "
            f"{LM_BATCH * LM_GEN / total_ms * 1e3:.2f} tokens/s; prefill "
            f"{pre_ms:.3f} ms, decode {dec_ms:.3f} ms per step (host clock)")
        del eng

    # examples/serve_cim.py's schedule through the continuous batcher.
    eng = ServeEngine(planned, cfg_k, max_len=96, batch=2)
    batcher = ContinuousBatcher(eng, eos_token=-1)
    rng = np.random.default_rng(0)
    for rid, (plen, gen) in enumerate(LM_SCHEDULE):
        batcher.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg_k.vocab_size, plen), max_new=gen))
    t0 = time.perf_counter()
    done = batcher.run_until_done()
    secs = time.perf_counter() - t0
    got = {r.rid: len(r.generated) for r in done}
    if got != {i: g for i, (_, g) in enumerate(LM_SCHEDULE)}:
        raise AssertionError(f"continuous batcher completed {got}")
    log(f"[lm] continuous batcher, cim-kernel, 2 slots: {len(done)} "
        f"requests, {sum(got.values())} tokens in {secs:.2f} s")
    del eng, batcher

    timings = lm_timings(ops, spec, cfg_k.n_layers)
    lm_profile(planned, cfg_k, prompts)
    return gen_launches, max_err, timings


def lm_timings(ops, spec, n_layers: int) -> dict:
    """B1 per LM operand (as phase 6), and per decode step and per
    prefill: the 7 launches of a layer times ``n_layers``."""
    from repro_torch.kernels import cim_mac

    sums = {"prefill": [0.0] * 4, "decode": [0.0] * 4}
    by = {"prefill": [0, 0], "decode": [0, 0]}
    for name, x, w in ops:
        m, k = x.shape
        n = w.shape[1]
        ms = cuda_time_ms(lambda x=x, w=w: cim_mac.gpq_matmul(x, w, spec))
        device_ms = graph_time_ms(
            lambda x=x, w=w: cim_mac.gpq_matmul(x, w, spec))
        plain_ms = cuda_time_ms(
            lambda x=x, w=w: cim_mac.gpq_matmul_plain(x, w, spec))
        nbytes = m * k * x.element_size() + k * n * w.element_size() + m * n * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * k * n * spec.weight_bits / INT8_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        kind = name.split()[0]
        for i, v in enumerate((ms, plain_ms, bound, device_ms)):
            sums[kind][i] += v * n_layers
        by[kind][bytes_ms >= ops_ms] += 1
        what = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[lm-timing] gpq_matmul {name:13s} [{m}, {k}]x[{k}, {n}]: "
            f"kernel {ms:.4f} ms over back-to-back wrapper calls "
            f"({device_ms:.4f} device ms in a graph), plain {plain_ms:.4f} "
            f"ms, bound {bound:.4f} ms ({what}; {nbytes / 1e6:.2f} MB, "
            f"{2 * m * k * n * spec.weight_bits / 1e9:.3f} G int8 ops)")
    out = {}
    for kind, (ms, plain_ms, bound, device_ms) in sums.items():
        bound_by = "bytes" if by[kind][1] >= by[kind][0] else "operations"
        out[kind] = (ms, plain_ms, bound, bound_by, device_ms)
        log(f"[lm-timing] gpq_matmul per {kind} ({n_layers} layers x "
            f"{len(LM_PROJECTIONS)} launches): kernel {ms:.4f} ms over "
            f"back-to-back wrapper calls ({device_ms:.4f} device ms in a "
            f"graph), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by})")
    return out


def lm_profile(planned, cfg, prompts):
    """One cim-kernel decode step under torch.profiler (reported, never
    failed, as phase 4's window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer

    b, s = prompts.shape
    caches = transformer.init_caches(cfg, b, s + 3, device="cuda")
    with torch.no_grad():
        logits, _ = transformer.prefill(planned, prompts, caches, cfg)
        tok = logits.argmax(-1)
        transformer.decode_step(planned, tok, s, caches, cfg)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            transformer.decode_step(planned, tok, s + 1, caches, cfg)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"[lm-profile] no device time in the trace ({window_ms:.2f} ms "
            f"window): not attributed")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[lm-profile] one cim-kernel decode step at batch {b}: "
        f"{window_ms:.3f} ms window (host clock), device busy {busy:.3f} ms "
        f"= {100 * busy / window_ms:.1f}% of it; top 10 device ops:")
    for ms, count, key in rows[:10]:
        log(f"[lm-profile]   {ms:9.4f} ms {100 * ms / busy:5.1f}% "
            f"x{count:<4d} {key[:100]}")


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
    lm_launches, lm_err, lm_t = phase_lm()

    report = {"kernels": [{
        "name": kern.name,
        "path": "resnet forward (14 macro convs)",
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
    b1 = KERNELS[0]
    report["kernels"].append({
        "name": b1.name,
        "path": f"{LM_ARCH} decode step (24 layers x 7 projections)",
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{b1.name}.cu",
        "replaces": b1.replaces,
        "launches": lm_launches,
        "max_abs_err": lm_err,
        "ms": lm_t["decode"][0],
        "device_ms": lm_t["decode"][4],
        "plain_ms": lm_t["decode"][1],
        "bound_ms": lm_t["decode"][2],
        "bound_by": lm_t["decode"][3],
        "library_ms": None,
        "prefill_ms": lm_t["prefill"][0],
        "prefill_device_ms": lm_t["prefill"][4],
        "prefill_plain_ms": lm_t["prefill"][1],
        "prefill_bound_ms": lm_t["prefill"][2],
    })
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
