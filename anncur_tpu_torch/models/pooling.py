"""Pooling over BERT sequence output.

Counterpart of ``anncur_tpu/models/pooling.py`` (reference
models/biencoder.py:108-124): cls_w_lin / cls / mean / max / lse, over
all positions including padding, as the reference does.
"""

from __future__ import annotations

import torch


def pool_sequence(
    seq_out: torch.Tensor,  # (b, s, h)
    pooled_out: torch.Tensor,  # (b, h) tanh-linear of CLS (BERT pooler)
    pooling_type: str,
) -> torch.Tensor:
    if pooling_type == "cls_w_lin":
        return pooled_out
    if pooling_type == "cls":
        return seq_out[:, 0, :]
    if pooling_type == "mean":
        return seq_out.mean(1)
    if pooling_type == "max":
        return seq_out.amax(1)
    if pooling_type == "lse":
        return torch.logsumexp(seq_out, 1)
    raise NotImplementedError(f"pooling_type={pooling_type!r} not supported")


def _first_position(token_ids: torch.Tensor, tag_id: int) -> torch.Tensor:
    """Index of the first occurrence of ``tag_id`` per row; a row without
    the tag resolves to position 0 (CLS), as in the JAX package (argmax of
    an all-zero mask; ``torch.argmax`` returns the first maximum)."""
    return torch.argmax((token_ids == tag_id).to(torch.int32), dim=1)
