"""The port's drivers: counterparts of the JAX repo's ``tools/`` scripts,
run as ``python -m anncur_tpu_torch.tools.<name>``. Each runs on the card
unless given ``--device cpu`` (or its tiny CPU mode), writes one JSON file
under ``results/torch/`` and records the card it ran on beside its
numbers. ``_common.py`` holds what they share."""
