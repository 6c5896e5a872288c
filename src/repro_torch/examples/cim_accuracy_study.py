"""The paper's Sec. IV hardware-aware system analysis as a runnable
study: train (or load) the ResNet baseline on the synthetic-CIFAR task,
then co-design {activated rows, cutoff, ADC bits} under hardware errors,
the loop that picked the paper's {8/16 rows, cutoff 0.5, 4-bit ADC}
operating point.

  PYTHONPATH=src python -m repro_torch.examples.cim_accuracy_study [--fast]

Noiseless evaluations run each conv through the kernels on the card (B1;
under a calibrated backend each layer's variant: B1, B2 adder-tree, B3
cell-adc); noisy ones through the scan, which draws the hardware errors.
Each calibrated backend is evaluated noisy, as the JAX package's study
does, and also noiseless, through the kernels. The sweeps write under
``build/sweeps/<name>_<config hash>/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import torch

from repro_torch.configs.base import CIMPolicy
from repro_torch.configs.resnet import (
    RESNET_CFG,
    cim_policy,
    dataset,
    train_resnet_baseline,
)
from repro_torch.core import calibrate_resnet
from repro_torch.core.calibrate import CalibrationGrid
from repro_torch.device import full_float32, resolve
from repro_torch.sweep import analyze, load_config
from repro_torch.sweep import runner as sweep_runner
from repro_torch.sweep.config import REPO_ROOT
from repro_torch.sweep.measures import evaluate

SWEEP_CONFIGS = REPO_ROOT / "configs" / "sweeps"
SWEEP_DIR = REPO_ROOT / "build" / "sweeps"
# Per profile: images per evaluation, calibration samples per layer and
# overrides of the two committed studies.
PROFILES = {
    "fast": dict(n_images=128, max_samples=128, fig7b={}, study={}),
    "full": dict(n_images=256, max_samples=256,
                 fig7b={"params": {"n_images": 256}},
                 study={"params": {"rows_active": [8, 16], "budget": 12,
                                   "max_samples": 256, "n_cal": 256,
                                   "n_held": 64}}),
}


def _study(name: str, device: torch.device, override: dict):
    """A committed study with the profile's overrides (and the device when
    it is not the card), writing under SWEEP_DIR/<name>_<hash>."""
    cfg = load_config(SWEEP_CONFIGS / f"{name}.json")
    params = dict(override.get("params", {}))
    if device.type != "cuda":
        params["device"] = str(device)
    cfg = cfg.override(axes=override.get("axes"), params=params)
    return cfg.override(out_dir=SWEEP_DIR / f"{cfg.name}_{cfg.config_hash}")


@full_float32()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device, error=SystemExit)
    prof = PROFILES["fast" if args.fast else "full"]
    n_images = prof["n_images"]
    out: dict = {}

    def acc(policy) -> float:
        return evaluate(params, bn, policy, n_images=n_images, device=device)

    print("training fp32 ResNet baseline on synthetic-CIFAR ...")
    params, bn = train_resnet_baseline(device=device)
    fp = out["fp"] = acc(CIMPolicy(mode="fp"))
    print(f"fp32 baseline accuracy: {fp:.3f} "
          "(paper: 92.34% on CIFAR-10)\n")

    print("=== cutoff sweep @ 16 rows, 4-bit ADC (paper Fig. 7a) ===")
    out["cutoff"] = {}
    for noisy in (False, True):
        row = []
        for cutoff in (0.25, 0.5, 0.75):
            a = out["cutoff"][cutoff, noisy] = acc(
                cim_policy(cutoff=cutoff, noisy=noisy))
            row.append(f"cutoff {cutoff}: {a:.3f}")
        tag = "w/ HW errors " if noisy else "ideal        "
        print(f"  {tag}" + "  ".join(row))

    print("\n=== rows x ADC bits @ cutoff 0.5, HW errors (Fig. 7b) ===")
    # The same table as a declarative sweep: the committed config expands
    # to the rows x bits grid, runs resumably (append-only points.jsonl;
    # re-running the example skips completed points) and the analysis
    # pass renders the summary table.
    fig7b = _study("accuracy_study", device, prof["fig7b"])
    sweep_runner.run(fig7b)
    for path in analyze(fig7b):
        print(f"  wrote {path}")
    recs = sorted(sweep_runner.read_points(fig7b).values(),
                  key=lambda r: r["index"])
    out["fig7b"] = {(r["point"]["rows_active"], r["point"]["adc_bits"]):
                    r["result"]["accuracy"]
                    for r in recs if r["status"] == "ok"}
    for rows in sorted({r for r, _ in out["fig7b"]}):
        cells = [f"{b}b: {a:.3f}" for (r, b), a in out["fig7b"].items()
                 if r == rows]
        print(f"  {rows:2d} rows  " + "  ".join(cells))

    print("\n=== the paper's operating point (Table I) ===")
    out["table1"] = {}
    for rows in (8, 16):
        for noisy in (False, True):
            a = out["table1"][rows, noisy] = acc(
                cim_policy(rows=rows, noisy=noisy))
            tag = "w/ HW" if noisy else "ideal"
            print(f"  {rows:2d} rows {tag}: {a:.3f} (drop {fp - a:+.3f})")

    # The sweep the tables above run by hand, as one API call: per conv
    # layer, pick the cheapest (adc_bits, rows, coarse/fine split) within
    # the fidelity slack, then execute the whole network through the
    # calibrated specs via the registered backend. The variant axis lets
    # each layer choose its macro family too: the paper's P-8T flash vs
    # the single-ADC analog adder network (arXiv:2212.04320) vs the
    # memory cell-embedded ADC (arXiv:2307.05944).
    pol = cim_policy(noisy=True)
    ideal = dataclasses.replace(
        pol, cim=dataclasses.replace(pol.cim, noisy=False))
    rcfg = dataclasses.replace(RESNET_CFG, cim=pol)
    images = torch.from_numpy(
        dataset().batch(64, step=0, train=False)["image"]).to(device)
    for title, name, grid in (
            ("hardware-aware per-layer calibration (core.calibrate)",
             "analog", CalibrationGrid()),
            ("macro-variant axis (core.variants)", "analog-variants",
             CalibrationGrid(variants=("p8t", "adder-tree", "cell-adc")))):
        print(f"\n=== {title} ===")
        result = calibrate_resnet(params, bn, images, rcfg, grid=grid,
                                  max_samples=prof["max_samples"])
        print(result.summary())
        result.register(name)
        noisy_acc = acc(dataclasses.replace(pol, backend=name))
        ideal_acc = acc(dataclasses.replace(ideal, backend=name))
        out[name] = {"noisy": noisy_acc, "ideal": ideal_acc,
                     "variants": sorted({lc.variant for lc in
                                         result.layers.values()})}
        print(f"accuracy with the '{name}' backend: {noisy_acc:.3f} (drop "
              f"{fp - noisy_acc:+.3f}); noiseless {ideal_acc:.3f}")

    print("\n=== accuracy-driven refinement + variants x vdd pareto ===")
    # Phase two of the co-design, as the committed sweep config: the
    # measure re-sweeps with the vdd axis (cost becomes J/op via the
    # energy model), greedily refines against real held-out top-1
    # accuracy (each candidate eval a full forward through
    # engine.execute / kernels.dispatch), and each grid point is one
    # (variant, vdd) projection of the refined plan. The analysis pass
    # renders the per-model accuracy-vs-TOPS/W frontier.
    study = _study("resnet_study", device, prof["study"])
    sweep_runner.run(study)
    jpath, mpath = analyze(study)
    print(mpath.read_text())
    print(f"(written to {jpath} and {mpath})")
    out["pareto"] = pathlib.Path(jpath)

    print("\nExpected orderings (the paper's claims): accuracy falls "
          "with more active rows under noise; 4-bit ADC ~ 5-bit under "
          "noise; cutoff 0.5 costs <~1-2% vs fp; the calibration sweep "
          "lands on the paper's 4-bit/16-row operating point; "
          "refinement never regresses TOPS/W and holds held-out top-1 "
          "within tolerance.")
    return out


if __name__ == "__main__":
    main()
