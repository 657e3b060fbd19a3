"""What the port's command-line tools share: the ``--device`` flag, the
architecture flags, and loading encoder weights from a checkpoint of
either package (``train/checkpoint.py::load_pytree`` and
``models/convert.py``) or drawing the port's seeded random weights."""

from __future__ import annotations

import argparse
import logging

import torch

from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.convert import biencoder_from_jax_params, crossencoder_from_jax_params
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.train.checkpoint import load_pytree
from anncur_tpu_torch.utils.device import resolve_device

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device; without a card only 'cpu' runs (nothing falls back to it by itself)",
    )


def add_arch_args(p: argparse.ArgumentParser) -> None:
    """bert-base by default; small values for smoke runs."""
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)


def device_of(args) -> torch.device:
    """``args.device`` resolved; the CLI exits with ``resolve_device``'s
    error where CUDA is asked for and absent."""
    try:
        return resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err


def spec_of(args, vocab_size: int) -> BertSpec:
    return BertSpec(
        vocab_size=vocab_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        intermediate_size=args.intermediate_size,
    )


def load_params(path: str):
    """The param tree of a checkpoint file of either package (its
    ``params`` entry, or the whole tree where it is bare)."""
    tree, _ = load_pytree(path)
    return tree["params"] if "params" in tree else tree


def crossencoder(
    spec: BertSpec, ckpt: str, cross_enc_type: str, dtype: torch.dtype, device, seed: int,
    logger: logging.Logger, warning: str,
) -> CrossEncoder:
    """The CE of ``ckpt``; without one, the port's random weights from
    ``seed`` after logging ``warning``."""
    if ckpt:
        return crossencoder_from_jax_params(load_params(ckpt), spec, cross_enc_type, device=device, dtype=dtype)
    logger.warning(warning)
    return CrossEncoder(spec=spec, cross_enc_type=cross_enc_type, compute_dtype=dtype, device=device, seed=seed)


def biencoder(
    spec: BertSpec, ckpt: str, pooling_type: str, dtype: torch.dtype, device, seed: int,
    logger: logging.Logger, warning: str,
) -> BiEncoder:
    """The separate-tower bi-encoder of ``ckpt`` (its linear heads where
    the tree has them); without one, random weights from ``seed``."""
    if ckpt:
        return biencoder_from_jax_params(
            load_params(ckpt), spec, pooling_type=pooling_type, embed_dim=spec.hidden_size,
            device=device, dtype=dtype,
        )
    logger.warning(warning)
    return BiEncoder(
        spec=spec, pooling_type=pooling_type, embed_dim=spec.hidden_size, compute_dtype=dtype,
        device=device, seed=seed,
    )
