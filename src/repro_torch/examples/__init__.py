"""The JAX package's four examples on this package, each a thin script
over ported modules, run as ``python -m repro_torch.examples.<name>``:

  quickstart          the macro op, B1 against the scan, a CIM linear
                      layer, plan/execute and the energy model
  serve_cim           five requests over two slots (ContinuousBatcher)
  train_lm            fp training, then CIM QAT through B1
  cim_accuracy_study  the paper's Sec. IV study on the ResNet baseline

Each takes the JAX package's flags and ``--device`` (default the card),
and has ``main(argv=None)``, which returns the numbers it prints and
runs float32 on the card with TF32 off (``repro_torch.device``).
Inputs come from numpy or ``torch.Generator`` seeds.
"""
