"""repro_torch: the P-8T SRAM charge-domain CIM reproduction on PyTorch/CUDA.

A port of the JAX package ``repro`` to PyTorch, with the TPU kernels
written again by hand for NVIDIA Hopper (``sm_90a``). Module names
mirror ``repro`` so each piece has an obvious counterpart:

  core         operating point, quantizers, ADC transfer, scan twin,
               the weight-stationary plan/execute engine
  kernels      the GPQ matmul kernel (CUDA, ``kernels/csrc``), its plain
               PyTorch version, the vectorized/slot formulations and the
               KernelKey dispatch table
  configs      execution policy, the LM ModelConfig records and the
               dense archs (qwen2-0.5b, qwen1.5-4b, yi-34b, gemma3-27b)
  models       ResNet (the paper's Table I network) and the LM stack
               (common layers, GQA attention with full and ring KV
               caches, MoE, RWKV-6, Mamba, transformer forward, loss,
               prefill and decode) over the engine
  serve        ServeEngine (prefill + greedy decode, weight-stationary
               plans, restore_planned), ContinuousBatcher, int8
               weight-only serving
  optim        AdamW, schedules, clipping, int8 gradient compression
  train        the train step factory and the fault-tolerant Trainer
  launch       the serving and training CLIs (``python -m
               repro_torch.launch.serve`` / ``.train``), the meshes and
               the dry run (``python -m repro_torch.launch.dryrun``)
  checkpoint   the msgpack + zlib tensor store (save, async, restore)
  distributed  the logical-axis sharding rules, ``shard_planned`` and the
               activation constraints
  sweep        the study harness (``python -m repro_torch.sweep``)
  pytree       the walker of the port's trees, in the JAX package's
               flattening order and leaf names
  data         the synthetic CIFAR-shaped dataset, the Markov LM stream
               and the sharded prefetch loader
  convert      numpy trees (as the JAX package saves them) -> tensors

The package imports ``torch`` and never ``jax`` or ``repro``. Entry
points take ``device=`` and default to ``"cuda"`` (``transformer.init``,
``transformer.init_caches``, ``ServeEngine``, the serving CLI's
``--device``, the ResNet loaders); pass ``"cpu"`` to run the plain
PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
