"""Quickstart: the P-8T SRAM CIM macro as a PyTorch matmul execution mode.

Runs in seconds:
  1. one voltage-domain macro op (the faithful circuit model),
  2. the same computation as an integer GPQ matmul: the scan against the
     hand-written kernel (B1; its plain version on the CPU),
  3. a CIM-executed linear layer on float data, with its STE gradient,
  4. the weight-stationary plan/execute split,
  5. the paper's operating-point numbers from the energy model.

Usage: PYTHONPATH=src python -m repro_torch.examples.quickstart
       [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import CIMPolicy
from repro_torch.core import (
    PAPER_OP_16ROWS,
    cim_matmul,
    cim_matmul_exact_int,
    cim_matmul_int,
    engine,
    macro_op,
    macro_report,
)
from repro_torch.device import full_float32, resolve
from repro_torch.kernels.ops import cim_matmul_kernel

KERNEL_BN = 16  # B1's column tile (16, 32 or 64); the operand has N = 8
VDDS = (0.6, 0.9, 1.2)


def operands(seed: int = 0) -> dict[str, np.ndarray]:
    """Every input of the five sections, from one numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "x16": rng.integers(0, 16, 16).astype(np.int32),
        "w16": rng.integers(-128, 128, (16, 8)).astype(np.int32),
        "xm": rng.integers(0, 16, (8, 64)).astype(np.int32),
        "wm": rng.integers(-128, 128, (64, 8)).astype(np.int8),
        # post-ReLU activations (the paper's CNN setting, act_symmetric)
        "x": np.maximum(rng.standard_normal((32, 128)), 0).astype(np.float32),
        "w": (0.1 * rng.standard_normal((128, 32))).astype(np.float32),
        "x_next": np.maximum(rng.standard_normal((32, 128)),
                             0).astype(np.float32),
    }


@full_float32()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device, error=SystemExit)
    ops = operands()
    t = {k: torch.from_numpy(v).to(device) for k, v in ops.items()}
    cfg = PAPER_OP_16ROWS
    out: dict = {}
    print(f"operating point: {cfg.rows_active} rows, cutoff {cfg.cutoff}, "
          f"{cfg.adc_bits}-bit coarse-fine ADC, threshold {cfg.threshold} "
          f"of {cfg.pmac_levels} pMAC levels, step {cfg.adc_step}")

    # ---- 1. one macro cycle in the voltage domain ----------------------
    op = macro_op(t["x16"], t["w16"], cfg)
    out["macro"] = {"v_abl": op.v_abl.cpu().numpy(),
                    "adc_codes": op.adc_codes.cpu().numpy(),
                    "outputs": op.outputs.cpu().numpy()}
    print("\nvoltage-domain macro op")
    print("  ABL voltages (col 0, 8 bit-planes):",
          np.round(out["macro"]["v_abl"][0], 4))
    print("  ADC codes   (col 0):", out["macro"]["adc_codes"][0])
    print("  shift-add outputs:", out["macro"]["outputs"].astype(np.int64))
    print("  exact int result :", ops["x16"].astype(np.int64) @ ops["w16"])

    # ---- 2. GPQ matmul: behavioral scan vs the hand-written kernel -----
    y_scan = cim_matmul_int(t["xm"], t["wm"], cfg)
    y_kernel = cim_matmul_kernel(t["xm"], t["wm"], cfg, bn=KERNEL_BN)
    y_exact_int = cim_matmul_exact_int(t["xm"], t["wm"])
    out["scan_equals_kernel"] = bool(torch.equal(y_scan, y_kernel))
    out["mean_adc_error"] = float(torch.mean(torch.abs(y_scan - y_exact_int)))
    out.update(y_scan=y_scan.cpu().numpy(), y_kernel=y_kernel.cpu().numpy(),
               y_exact_int=y_exact_int.cpu().numpy())
    print("\nGPQ matmul [8,64]x[64,8]")
    print(f"  scan == kernel: {out['scan_equals_kernel']}")
    print(f"  mean |ADC quantization error| vs exact: "
          f"{out['mean_adc_error']:.2f} (ADC step {cfg.adc_step})")

    # ---- 3. a CIM-executed linear layer on float data ------------------
    x, w = t["x"], t["w"]
    y_fp = x @ w
    y_exact = cim_matmul(x, w, cfg, mode="cim-exact", act_symmetric=True)
    y_cim = cim_matmul(x, w, cfg, mode="cim", act_symmetric=True)
    norm = torch.linalg.norm(y_fp)
    out["rel_err_exact"] = float(torch.linalg.norm(y_exact - y_fp) / norm)
    out["rel_err_cim"] = float(torch.linalg.norm(y_cim - y_fp) / norm)
    out.update(y_cim_exact=y_exact.detach().cpu().numpy(),
               y_cim=y_cim.detach().cpu().numpy())
    print("\nfloat linear layer through the macro (quant + ADC + dequant)")
    print(f"  4b-act/8b-weight quantization alone : "
          f"{out['rel_err_exact']:.1%} rel err")
    print(f"  + per-16-row-group 4-bit ADC        : "
          f"{out['rel_err_cim']:.1%} rel err")
    print("  (the ADC term dominates -- exactly why the paper co-designs "
          "{rows, cutoff, ADC bits} against accuracy)")

    # gradients flow through the macro (STE) -> QAT-ready
    wg = w.clone().requires_grad_()
    loss = torch.sum(cim_matmul(x, wg, cfg, mode="cim",
                                act_symmetric=True) ** 2)
    (g,) = torch.autograd.grad(loss, wg)
    out["ste_grad_norm"] = float(torch.linalg.norm(g))
    print(f"  STE gradient norm: {out['ste_grad_norm']:.3f}")

    # ---- 4. weight-stationary plan/execute (the serving hot path) ------
    policy = CIMPolicy(mode="cim", cim=cfg, act_symmetric=True)
    plan = engine.plan_weights(w, cfg, policy)  # codes+colsum+planes, once
    y_planned = engine.execute(x, plan, policy)
    y_next = engine.execute(t["x_next"], plan, policy)  # plan reused
    out["planned_equals_one_shot"] = bool(torch.equal(y_planned, y_cim))
    out.update(y_planned=y_planned.cpu().numpy(),
               y_next=y_next.cpu().numpy())
    print("\nweight-stationary plan/execute")
    print(f"  planned == one-shot: {out['planned_equals_one_shot']}")
    print(f"  plan storage: codes {plan.codes.dtype}, grouped planes "
          f"{plan.planes.dtype}{list(plan.planes.shape)} [G,B,rows,N], "
          f"backends {engine.backend_names()}")
    print(f"  second batch through same plan: {tuple(y_next.shape)}")

    # ---- 5. the paper's headline numbers -------------------------------
    print("\nanalytical macro model (28nm anchors)")
    out["energy"] = []
    for vdd in VDDS:
        rep = macro_report(cfg.replace(vdd=vdd))
        out["energy"].append((vdd, rep.tops_per_w, rep.freq_mhz))
        print(f"  {vdd:.1f} V: {rep.tops_per_w:6.2f} TOPS/W, "
              f"{rep.freq_mhz:5.1f} MHz")
    print("\n(Paper: 50.07 TOPS/W @ 0.6 V, 9.77 @ 1.2 V, "
          "accuracy 91.46% CIFAR-10 @ 8 rows.)")
    return out


if __name__ == "__main__":
    main()
