"""End-to-end training driver: train a small LM for a few hundred steps
with the full substrate (sharded loader, AdamW + schedule, periodic async
checkpoints, crash-safe resume) and compare fp training against CIM-QAT
(training *through* the macro model with STE), the LM analogue of the
paper's hardware-aware simulations.

  PYTHONPATH=src python -m repro_torch.examples.train_lm
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --cim

The model is the qwen2-family block at a ~6M-param scale (the substrate
is identical to the full configs; only dims shrink). The QAT run's
macro is B1 (``cim-kernel``; its plain version on the CPU, which equals
the behavioral ``cim`` scan bit for bit). A rerun resumes from the
checkpoints under ``--ckpt-dir`` and continues the data stream there.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import torch

from repro_torch import convert
from repro_torch.configs.base import CIMPolicy, get_config
from repro_torch.core.params import PAPER_OP_16ROWS
from repro_torch.data import MarkovLM, ShardedLoader
from repro_torch.device import full_float32, resolve
from repro_torch.models import transformer
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    init_train_state,
    make_key,
    make_train_step,
)

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "examples" / "train_lm"
CIM_MIN_STEPS = 30  # the QAT run takes max(steps // 4, this) steps


def build_cfg(cim: bool):
    cfg = get_config("qwen2_0_5b", smoke=True).replace(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
        # vocab 64 with deterministic order-2 transitions (branching 1)
        # gives a 4k-entry table a 5M model memorizes in a few hundred
        # steps: loss floor 0, unigram ~ ln(64) = 4.16.
        vocab_size=64, activation_dtype="float32",
    )
    if cim:
        cfg = cfg.replace(
            cim=CIMPolicy(mode="cim-kernel", cim=PAPER_OP_16ROWS,
                          apply_to_logits=False))
    return cfg


def run(cfg, steps, batch, seq, ckpt_dir, label, device) -> dict:
    # Drawn on the host, so every device starts from the same weights.
    params = convert.to_torch(transformer.init(0, cfg, device="cpu"),
                              device=device)
    n = sum(t.numel() for t in tree_leaves(params))

    def loss(p, b, generator):
        return transformer.loss_fn(p, b, cfg, generator=generator)

    train_step = make_train_step(
        loss,
        OptimizerConfig(lr=3e-3, total_steps=steps,
                        warmup_steps=max(steps // 20, 1)),
    )
    losses = []  # every step's, where the history keeps every 20th

    def step_fn(state, b):
        state, metrics = train_step(state, b)
        losses.append(metrics["loss"])
        return state, metrics

    lm = MarkovLM(cfg.vocab_size, seed=0, branching=1)

    def batch_fn(s, sh, ns):
        return {k: torch.from_numpy(v).long().to(device) for k, v in
                lm.batch(batch, seq, s, shard=sh, n_shards=ns).items()}

    loader = ShardedLoader(batch_fn)
    trainer = Trainer(step_fn, init_train_state(make_key(0), params), loader,
                      TrainerConfig(checkpoint_dir=str(ckpt_dir),
                                    checkpoint_every=100, log_every=20))
    resumed = trainer.maybe_resume()
    if resumed:
        loader.close()  # the stream is step-addressed: continue it there
        trainer.loader = loader = ShardedLoader(batch_fn, start_step=resumed)
        print(f"[{label}] resumed from step {resumed}")
    t0 = time.time()
    try:
        hist = trainer.run(steps - resumed)
        trainer.final_checkpoint()
    finally:
        loader.close()
    dt = time.time() - t0
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[{label}] params={n/1e6:.2f}M steps={steps} "
          f"loss {first:.3f} -> {last:.3f} "
          f"({batch * seq * (steps - resumed) / dt:.0f} tok/s)")
    for h in hist:
        print(f"[{label}] step {h['step']:4d} loss {h['loss']:.4f}")
    return {"resumed": resumed, "first": first, "last": last,
            "losses": [float(v) for v in losses], "seconds": dt}


@full_float32()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--cim", action="store_true",
                    help="also run CIM-QAT (slower: macro forward)")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device, error=SystemExit)

    out = {"fp": run(build_cfg(cim=False), args.steps, args.batch, args.seq,
                     args.ckpt_dir + "_fp", "fp", device)}
    if args.cim:
        out["cim-qat"] = run(build_cfg(cim=True),
                             max(args.steps // 4, CIM_MIN_STEPS),
                             args.batch, args.seq, args.ckpt_dir + "_cim",
                             "cim-qat", device)
        print(f"\nfp final loss {out['fp']['last']:.3f}; cim-qat (fewer "
              f"steps) {out['cim-qat']['last']:.3f} -- training *through* "
              "the ADC transfer converges (STE), the paper's co-design "
              "loop at LM scale.")
    return out


if __name__ == "__main__":
    main()
