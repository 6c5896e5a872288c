"""Training CLI.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --steps 50 --batch 8 --seq 128 [--cim-mode cim-kernel] \\
      [--ckpt-dir build/train --resume]

Random weights from ``--seed`` at the arch's published widths and depth
(``--smoke`` for its narrow configuration), trained with AdamW on
``data.synthetic.MarkovLM`` batches through ``ShardedLoader``. Runs on
``cuda`` unless given ``--device cpu``. Under a CIM mode every
projection's forward runs through the macro path (B1 under cim-kernel
on the card) and its backward is the straight-through estimator.
Checkpoints go to ``--ckpt-dir`` every ``--ckpt-every`` steps and at the
end; ``--resume`` continues from the latest one there.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import CIMPolicy, get_config
from repro_torch.data import MarkovLM, ShardedLoader
from repro_torch.device import resolve
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--cim-mode", default=None,
                    help="fp | cim-exact | cim | cim-kernel")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve(args.device, error=SystemExit)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.cim_mode:
        cfg = cfg.replace(cim=CIMPolicy(mode=args.cim_mode))
    params = transformer.init(args.seed, cfg, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M "
          f"cim={cfg.cim.mode} device={device}")

    def loss(p, batch, generator):
        return transformer.loss_fn(p, batch, cfg, generator=generator)

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1))
    step_fn = make_train_step(loss, opt_cfg, microbatches=args.microbatches,
                              compress=args.compress_grads)
    state = init_train_state(make_key(args.seed), params,
                             compress=args.compress_grads)

    lm = MarkovLM(cfg.vocab_size)

    def batch_fn(step, shard, n):
        b = lm.batch(args.batch, args.seq, step, shard=shard, n_shards=n)
        return {k: torch.from_numpy(v).long().to(device)
                for k, v in b.items()}

    loader = ShardedLoader(batch_fn)
    tcfg = TrainerConfig(checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=args.ckpt_every)
    trainer = Trainer(step_fn, state, loader, tcfg)
    if args.resume:
        at = trainer.maybe_resume()
        loader.close()
        # the stream is step-addressed: continue it at the restored step
        trainer.loader = loader = ShardedLoader(batch_fn, start_step=at)
        print(f"resumed at step {at}")
    hist = trainer.run(args.steps)
    trainer.final_checkpoint()
    loader.close()
    for h in hist:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"{h['sec'] * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
