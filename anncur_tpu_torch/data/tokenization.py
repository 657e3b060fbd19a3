"""Mention/entity token representation builders.

A copy of ``anncur_tpu/data/tokenization.py`` (importing that module
loads JAX through ``anncur_tpu/models``): the token-level builders and
their id-level fast paths, which give the same ids. Exact
semantic parity with the reference builders
(utils/data_process.py:949-1040, originally from BLINK):

- mention: ``[CLS] left [unused0] mention [unused1] right [SEP]`` with
  left/right context quota balancing around the mention,
- entity: ``[CLS] title [unused2] description [SEP]``,
- pair: mention ⧺ entity[1:] (drop the entity CLS),
- fixed length, zero-padded.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from anncur_tpu_torch.models.special_tokens import (
    ENT_END_TAG,
    ENT_START_TAG,
    ENT_TITLE_TAG,
    check_tag_ids,
)
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer


def _context_quotas(n_mention: int, n_left: int, n_right: int, max_seq_length: int):
    """(left, right) context token quotas around a mention: half each,
    the unused part of one side given to the other
    (reference: get_context_representation, utils/data_process.py:965-1008)."""
    left_quota = (max_seq_length - n_mention) // 2 - 1
    right_quota = max_seq_length - n_mention - left_quota - 2
    if n_left <= left_quota:
        if n_right > right_quota:
            right_quota += left_quota - n_left
    elif n_right <= right_quota:
        left_quota += right_quota - n_right
    return left_quota, right_quota


def get_context_representation(
    sample: Dict,
    tokenizer: WordPieceTokenizer,
    max_seq_length: int,
    mention_key: str = "mention",
    context_key: str = "context",
    ent_start_token: str = ENT_START_TAG,
    ent_end_token: str = ENT_END_TAG,
) -> Dict[str, List]:
    """Tokenize a mention-in-context record with quota balancing
    (reference: utils/data_process.py:965-1008)."""
    mention_tokens: List[str] = []
    if sample.get(mention_key):
        if ent_start_token == ENT_START_TAG:
            check_tag_ids(tokenizer.vocab)  # tags read at fixed ids by the encoders
        mention_tokens = tokenizer.tokenize(sample[mention_key])
        mention_tokens = [ent_start_token] + mention_tokens + [ent_end_token]

    context_left = tokenizer.tokenize(sample[context_key + "_left"])
    context_right = tokenizer.tokenize(sample[context_key + "_right"])

    left_quota, right_quota = _context_quotas(len(mention_tokens), len(context_left), len(context_right), max_seq_length)
    # the same [-0:] whole-left-context quirk as the id-level builder
    context_tokens = (
        context_left[-left_quota:] + mention_tokens + context_right[:right_quota]
    )
    context_tokens = ["[CLS]"] + context_tokens + ["[SEP]"]
    input_ids = tokenizer.convert_tokens_to_ids(context_tokens)[:max_seq_length]
    input_ids = input_ids + [0] * (max_seq_length - len(input_ids))
    return {"tokens": context_tokens, "ids": input_ids}


def get_candidate_representation(
    candidate_desc: str,
    tokenizer: WordPieceTokenizer,
    max_seq_length: int,
    candidate_title: str | None = None,
    title_tag: str = ENT_TITLE_TAG,
) -> Dict[str, List]:
    """Tokenize an entity (title [unused2] description)
    (reference: utils/data_process.py:1011-1040)."""
    cand_tokens = tokenizer.tokenize(candidate_desc)
    if candidate_title is not None:
        if title_tag == ENT_TITLE_TAG:
            check_tag_ids(tokenizer.vocab)
        title_tokens = tokenizer.tokenize(candidate_title)
        cand_tokens = title_tokens + [title_tag] + cand_tokens
    cand_tokens = cand_tokens[: max_seq_length - 2]
    cand_tokens = [tokenizer.cls_token] + cand_tokens + [tokenizer.sep_token]
    input_ids = tokenizer.convert_tokens_to_ids(cand_tokens)
    input_ids = input_ids + [0] * (max_seq_length - len(input_ids))
    return {"tokens": cand_tokens, "ids": input_ids}


def get_context_representation_ids(
    sample: Dict,
    tokenizer: WordPieceTokenizer,
    max_seq_length: int,
) -> List[int]:
    """Mention-in-context ids with quota balancing
    (reference: utils/data_process.py:965-1008)."""
    v = tokenizer.vocab
    cls_id, sep_id = v["[CLS]"], v["[SEP]"]
    start_id, end_id = v[ENT_START_TAG], v[ENT_END_TAG]

    mention_ids: List[int] = []
    if sample.get("mention"):
        mention_ids = [start_id] + tokenizer.encode(sample["mention"]) + [end_id]
    left = tokenizer.encode(sample["context_left"])
    right = tokenizer.encode(sample["context_right"])

    left_quota, right_quota = _context_quotas(len(mention_ids), len(left), len(right), max_seq_length)

    # BLINK-semantics quirk kept bug-for-bug (reference
    # utils/data_process.py:991): `left[-left_quota:]` with left_quota == 0
    # is `[-0:]`, i.e. the WHOLE left context (the final [:max_seq_length]
    # truncation then clips it). Token ids must match reference
    # checkpoints, so this is not "fixed".
    ids = (
        [cls_id] + left[-left_quota:] + mention_ids + right[:right_quota] + [sep_id]
    )[:max_seq_length]
    return ids + [0] * (max_seq_length - len(ids))


def get_candidate_representation_ids(
    candidate_desc: str,
    tokenizer: WordPieceTokenizer,
    max_seq_length: int,
    candidate_title: str | None = None,
) -> List[int]:
    """Entity ids: title [unused2] description
    (reference: utils/data_process.py:1011-1040)."""
    v = tokenizer.vocab
    ids = tokenizer.encode(candidate_desc)
    if candidate_title is not None:
        check_tag_ids(v)  # tags read at fixed ids by the encoders
        ids = tokenizer.encode(candidate_title) + [v[ENT_TITLE_TAG]] + ids
    ids = [v["[CLS]"]] + ids[: max_seq_length - 2] + [v["[SEP]"]]
    return ids + [0] * (max_seq_length - len(ids))


def create_input_label_pair(input_token_idxs, label_token_idxs):
    """Concatenate mention ⧺ entity dropping the entity CLS
    (reference: utils/data_process.py:949-959)."""
    input_token_idxs = np.asarray(input_token_idxs)
    label_token_idxs = np.asarray(label_token_idxs)
    return np.concatenate([input_token_idxs, label_token_idxs[1:]])


def pair_token_matrix(mention_ids: np.ndarray, entity_ids: np.ndarray) -> np.ndarray:
    """One mention against many entities: (n_e, L1 + L2 - 1) pairs
    (``indexer/score_matrix.py::build_pairs`` is the device-side batch
    version)."""
    n_e = entity_ids.shape[0]
    left = np.broadcast_to(mention_ids, (n_e, mention_ids.shape[0]))
    return np.concatenate([left, entity_ids[:, 1:]], axis=1)


def tokenize_mentions(
    mentions: Sequence[Dict],
    tokenizer: WordPieceTokenizer,
    max_seq_length: int,
) -> np.ndarray:
    """(n_ments, L) int32 token-id matrix."""
    out = np.zeros((len(mentions), max_seq_length), np.int32)
    for i, m in enumerate(mentions):
        out[i] = get_context_representation_ids(m, tokenizer, max_seq_length)
    return out


def tokenize_entities(
    entities: Sequence,
    tokenizer: WordPieceTokenizer,
    max_seq_length: int,
) -> np.ndarray:
    """(n_ents, L) int32 matrix from [(title, description)]
    (reference CLI: utils/tokenize_entities.py:21-40)."""
    out = np.zeros((len(entities), max_seq_length), np.int32)
    for i, (title, desc) in enumerate(entities):
        out[i] = get_candidate_representation_ids(desc, tokenizer, max_seq_length, title)
    return out
