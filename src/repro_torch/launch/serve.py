"""Serving CLI: prefill a batch of prompts, then greedy-decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \\
      --batch 4 --prompt-len 128 --gen 32 --cim-mode cim-kernel

Random weights from ``--seed`` at the arch's published widths and depth
(``--smoke`` for its narrow CPU configuration); prompts from
``data.synthetic.MarkovLM``. Runs on ``cuda`` unless given
``--device cpu``. Under a CIM mode (at the default operating point, the
paper's) the weights are planned once; without one they serve as
float32.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import CIMPolicy, get_config
from repro_torch.data.synthetic import MarkovLM
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cim-mode", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.cim_mode:
        cfg = cfg.replace(cim=CIMPolicy(mode=args.cim_mode))
    params = transformer.init(args.seed, cfg, device=device)
    engine = ServeEngine(params, cfg,
                         max_len=args.prompt_len + args.gen + 1,
                         batch=args.batch, device=device,
                         plan=cfg.cim.mode != "fp")
    prompts = MarkovLM(cfg.vocab_size, seed=args.seed).sample(
        args.batch, args.prompt_len - 1, seed=args.seed)
    prompts = torch.from_numpy(prompts).long().to(device)
    _sync(device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} mode={cfg.cim.mode} on {where}: generated "
          f"{toks} tokens in {dt:.2f} s ({toks / dt:.1f} tokens/s, first "
          f"call included)")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
