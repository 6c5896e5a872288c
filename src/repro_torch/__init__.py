"""repro_torch: the P-8T SRAM charge-domain CIM reproduction on PyTorch/CUDA.

A port of the JAX package ``repro`` to PyTorch, with the TPU kernels
written again by hand for NVIDIA Hopper (``sm_90a``). Module names
mirror ``repro`` so each piece has an obvious counterpart:

  core         operating point, quantizers, ADC transfer, scan twin,
               the weight-stationary plan/execute engine
  kernels      the GPQ matmul kernel (CUDA, ``kernels/csrc``), its plain
               PyTorch version, the vectorized/slot formulations and the
               KernelKey dispatch table
  models       ResNet (the paper's Table I network) over the engine
  checkpoint   read path of the msgpack + zlib tensor store
  data         the synthetic CIFAR-shaped dataset
  convert      numpy trees (as the JAX package saves them) -> tensors

The package imports ``torch`` and never ``jax`` or ``repro``. Entry
points take ``device=`` and default to ``"cuda"``; pass ``"cpu"`` to
run the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
