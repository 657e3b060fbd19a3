"""Pooling over BERT sequence output.

Counterpart of ``anncur_tpu/models/pooling.py`` (reference
models/biencoder.py:108-124): cls_w_lin / cls / mean / max / lse, over
all positions including padding, as the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from anncur_tpu_torch.models.special_tokens import ENT_END_ID, ENT_START_ID, ENT_TITLE_ID


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


def gather_token_embedding(seq_out: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """seq_out[i, positions[i], :] for each row i."""
    idx = positions.long()[:, None, None].expand(-1, 1, seq_out.shape[-1])
    return torch.gather(seq_out, 1, idx)[:, 0, :]


def special_token_embeds(
    seq_out: torch.Tensor,  # (b, s, h)
    token_ids: torch.Tensor,  # (b, s)
    start_id: int = ENT_START_ID,
    end_id: int = ENT_END_ID,
    title_id: int = ENT_TITLE_ID,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mention_embed, entity_embed) per the w_embeds cross-encoder:
    mention = mean of the [unused0]/[unused1] positions, entity = the
    [unused2] position (reference: models/crossencoder.py:100-124)."""
    return mention_embed(seq_out, token_ids, start_id, end_id), entity_embed(seq_out, token_ids, title_id)


def mention_embed(seq_out, token_ids, start_id: int = ENT_START_ID, end_id: int = ENT_END_ID) -> torch.Tensor:
    start = gather_token_embedding(seq_out, _first_position(token_ids, start_id))
    end = gather_token_embedding(seq_out, _first_position(token_ids, end_id))
    return (start + end) / 2.0


def entity_embed(seq_out, token_ids, title_id: int = ENT_TITLE_ID) -> torch.Tensor:
    return gather_token_embedding(seq_out, _first_position(token_ids, title_id))
