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
  models       ResNet (the paper's Table I network) and the dense LM
               stack (common layers, GQA attention with full and ring KV
               caches, transformer prefill/decode) over the engine
  serve        ServeEngine (prefill + greedy decode, weight-stationary
               plans), ContinuousBatcher, int8 weight-only serving
  launch       the serving CLI (``python -m repro_torch.launch.serve``)
  checkpoint   read path of the msgpack + zlib tensor store
  data         the synthetic CIFAR-shaped dataset and the Markov LM stream
  convert      numpy trees (as the JAX package saves them) -> tensors

The package imports ``torch`` and never ``jax`` or ``repro``. Entry
points take ``device=`` and default to ``"cuda"`` (``transformer.init``,
``transformer.init_caches``, ``ServeEngine``, the serving CLI's
``--device``, the ResNet loaders); pass ``"cpu"`` to run the plain
PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
