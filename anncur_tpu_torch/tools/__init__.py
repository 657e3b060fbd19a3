"""The port's drivers: counterparts of the JAX repo's ``tools/`` scripts,
run as ``python -m anncur_tpu_torch.tools.<name>``. Each runs on the card
unless given ``--device cpu`` (or its tiny CPU mode), but for the two that
JAX ran on the CPU by design, ``adaptive_matched_recall`` (an oracle sweep
with no encoder) and ``make_trained_ce_matrix``, which take ``--device
cuda``. Each writes one JSON (or ``.npz``) file under ``results/torch/``
and records the card it ran on beside its numbers. ``_common.py`` holds
what they share."""
