"""The benchmark of ``anncur_tpu_torch`` on one H100 (see README.md)."""
