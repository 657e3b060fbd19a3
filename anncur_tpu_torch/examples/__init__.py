"""The JAX package's user examples (``examples/``), ported: run as
``python -m anncur_tpu_torch.examples.<name> [--device cpu]``."""
