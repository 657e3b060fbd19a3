"""Dataset assembly: tokenized tensors + negatives -> train batches.

A numpy copy of ``anncur_tpu/train/data.py`` (parity with reference
utils/data_process.py:466-946, get_dataloader / get_ent_link_dataset /
get_ent_link_ce_dataset): datasets, world merging, negative mining per
epoch, bi-encoder batches (input, pos, negs[b,n,L]), cross-encoder pair
batches (pos_pairs, neg_pairs[b,n,2L]) and distillation batches (top-N
labels + teacher scores, or triplets). The miners that need MIPS
(bi-encoder hard negatives) run it on ``device``: kernel B on the card.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from anncur_tpu_torch.data.tokenization import create_input_label_pair
from anncur_tpu_torch.train import negatives as negs_mod
from anncur_tpu_torch.utils.device import DeviceLike

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass
class EntLinkDataset:
    """Tokenized arrays for one (or merged) world(s)."""

    mention_tokens: np.ndarray  # (n_m, Lm)
    entity_tokens: np.ndarray  # (n_e, Le)
    gt_labels: np.ndarray  # (n_m,)
    mention_texts: Optional[Sequence[str]] = None
    entities: Optional[Sequence] = None  # [(title, desc)]
    score_matrix: Optional[np.ndarray] = None  # teacher scores for distill
    # multi-world merge metadata: per-mention world index and per-world
    # [start, end) ranges in the concatenated entity matrix. Negatives
    # are mined within each mention's world (the reference trains on
    # per-world dataloaders, models/pairwise_trainer.py:42-164).
    mention_world: Optional[np.ndarray] = None  # (n_m,)
    world_ent_ranges: Optional[List] = None  # [(start, end)]

    @property
    def n_ments(self) -> int:
        return self.mention_tokens.shape[0]

    @property
    def n_ents(self) -> int:
        return self.entity_tokens.shape[0]


def merge_worlds(datasets: Sequence["EntLinkDataset"]) -> "EntLinkDataset":
    """Concatenate per-world datasets: entity ids are offset into one
    global entity matrix; world metadata is kept so negative mining and
    retrieval stay within-world."""
    if len(datasets) == 1:
        return datasets[0]
    ent_offsets = np.cumsum([0] + [d.n_ents for d in datasets])
    gt = np.concatenate([d.gt_labels + ent_offsets[i] for i, d in enumerate(datasets)])
    lm = max(d.mention_tokens.shape[1] for d in datasets)
    le = max(d.entity_tokens.shape[1] for d in datasets)

    def pad(mat, width):
        out = np.zeros((mat.shape[0], width), mat.dtype)
        out[:, : mat.shape[1]] = mat
        return out

    texts = None
    if all(d.mention_texts is not None for d in datasets):
        texts = [t for d in datasets for t in d.mention_texts]
    ents = None
    if all(d.entities is not None for d in datasets):
        ents = [e for d in datasets for e in d.entities]
    score_matrix = None
    if all(d.score_matrix is not None for d in datasets):
        # block-aligned teacher matrix: each world's scores land at its
        # mention rows x its entity range; cross-world cells get a large
        # negative fill so distill top-N selection stays within-world.
        # (dropping the matrix silently broke multi-domain distillation:
        # distill_batches raised 'requires a teacher score matrix'.)
        n_m_total = sum(d.n_ments for d in datasets)
        score_matrix = np.full((n_m_total, int(ent_offsets[-1])), -1e9, np.float32)
        row = 0
        for i, d in enumerate(datasets):
            score_matrix[
                row : row + d.n_ments, ent_offsets[i] : ent_offsets[i + 1]
            ] = np.asarray(d.score_matrix, np.float32)
            row += d.n_ments
    return EntLinkDataset(
        mention_tokens=np.concatenate([pad(d.mention_tokens, lm) for d in datasets]),
        entity_tokens=np.concatenate([pad(d.entity_tokens, le) for d in datasets]),
        gt_labels=gt.astype(np.int64),
        mention_texts=texts,
        entities=ents,
        score_matrix=score_matrix,
        mention_world=np.concatenate(
            [np.full(d.n_ments, i, np.int32) for i, d in enumerate(datasets)]
        ),
        world_ent_ranges=[
            (int(ent_offsets[i]), int(ent_offsets[i + 1])) for i in range(len(datasets))
        ],
    )


def mine_negatives(
    data: EntLinkDataset,
    neg_strategy: str,
    num_negs: int,
    seed: int = 0,
    input_embeds: Optional[np.ndarray] = None,
    label_embeds: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """(n_m, num_negs) negative label ids per strategy
    (reference dispatch: get_ent_link_dataset, data_process.py:629-687).
    On merged multi-world datasets, negatives stay within each mention's
    world (its own entity range). ``device`` runs the bienc_hard_negs
    and tfidf_hard_negs MIPS."""
    if data.mention_world is not None and data.world_ent_ranges is not None:
        out = np.empty((data.n_ments, num_negs), np.int64)
        for w, (start, end) in enumerate(data.world_ent_ranges):
            sel = np.nonzero(data.mention_world == w)[0]
            if len(sel) == 0:
                continue
            sub = EntLinkDataset(
                mention_tokens=data.mention_tokens[sel],
                entity_tokens=data.entity_tokens[start:end],
                gt_labels=data.gt_labels[sel] - start,
                mention_texts=None if data.mention_texts is None else [data.mention_texts[i] for i in sel],
                entities=None if data.entities is None else data.entities[start:end],
                score_matrix=None if data.score_matrix is None else data.score_matrix[sel, start:end],
            )
            sub_embeds = None if input_embeds is None else input_embeds[sel]
            lab_embeds = None if label_embeds is None else label_embeds[start:end]
            out[sel] = (
                mine_negatives(sub, neg_strategy, num_negs, seed + w, sub_embeds, lab_embeds, device)
                + start
            )
        return out
    if neg_strategy in ("random", "dummy"):
        return negs_mod.get_random_negs(data.gt_labels, data.n_ents, num_negs, seed)
    if neg_strategy == "bienc_hard_negs":
        if input_embeds is None or label_embeds is None:
            raise ValueError("bienc_hard_negs requires current-tower embeddings")
        return negs_mod.get_hard_negs_from_embeds(
            input_embeds, label_embeds, data.gt_labels, num_negs, device
        )
    if neg_strategy == "tfidf_hard_negs":
        if data.mention_texts is None or data.entities is None:
            raise ValueError("tfidf_hard_negs requires raw texts")
        return negs_mod.get_hard_negs_tfidf(
            data.mention_texts, data.entities, data.gt_labels, num_negs, device
        )
    if neg_strategy == "precomp":
        if data.score_matrix is None:
            raise ValueError("precomp negatives require a score matrix")
        top = negs_mod.get_precomputed_ents_w_scores(data.score_matrix, num_negs + 1)
        out = np.empty((data.n_ments, num_negs), np.int64)
        for i, gt in enumerate(data.gt_labels):
            row = [j for j in top["indices"][i] if j != gt][:num_negs]
            while len(row) < num_negs:
                row.append(row[-1])
            out[i] = row
        return out
    raise NotImplementedError(f"neg_strategy={neg_strategy!r}")


def _batch_order(n: int, shuffle: bool, seed: int) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order


def _batch_indices(
    order: np.ndarray, batch_size: int, drop_remainder: bool, pad_remainder: bool
) -> Iterator[np.ndarray]:
    """Row indices of each batch in ``order``. A short tail is dropped
    (``drop_remainder``, when there is at least one full batch), padded by
    wrapping round ``order`` (``pad_remainder``: fixed batch shapes; np.resize
    cycles when ``order`` is shorter than a batch), or yielded as it is
    (eval: every example exactly once)."""
    n = len(order)
    for i in range(0, n, batch_size):
        idx = order[i : i + batch_size]
        if len(idx) < batch_size:
            if drop_remainder and n >= batch_size:
                return
            if pad_remainder:
                idx = np.resize(np.concatenate([idx, order]), batch_size)
        yield idx


def bienc_batches(
    data: EntLinkDataset,
    neg_labels: np.ndarray,  # (n_m, n_negs)
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    pad_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'input': (b,Lm), 'pos': (b,Le), 'negs': (b,n,Le)}, fixed
    batch shapes by default (the last partial batch dropped or padded by
    wrapping)."""
    order = _batch_order(data.n_ments, shuffle, seed)
    for idx in _batch_indices(order, batch_size, drop_remainder, pad_remainder):
        yield {
            "input": data.mention_tokens[idx],
            "pos": data.entity_tokens[data.gt_labels[idx]],
            "negs": data.entity_tokens[neg_labels[idx]],
        }


def crossenc_batches(
    data: EntLinkDataset,
    neg_labels: np.ndarray,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    pad_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'pos_pairs': (b, Lp), 'neg_pairs': (b, n, Lp)} where
    Lp = Lm + Le - 1 (pair concat dropping the entity CLS,
    reference: _get_paired_token_idxs, data_process.py:917-946)."""
    lm = data.mention_tokens.shape[1]
    le = data.entity_tokens.shape[1]
    lp = lm + le - 1
    num_negs = neg_labels.shape[1]
    order = _batch_order(data.n_ments, shuffle, seed)
    for idx in _batch_indices(order, batch_size, drop_remainder, pad_remainder):
        b = len(idx)
        pos_pairs = np.empty((b, lp), np.int32)
        neg_pairs = np.empty((b, num_negs, lp), np.int32)
        for row, j in enumerate(idx):
            m = data.mention_tokens[j]
            pos_pairs[row] = create_input_label_pair(m, data.entity_tokens[data.gt_labels[j]])
            for t, nl in enumerate(neg_labels[j]):
                neg_pairs[row, t] = create_input_label_pair(m, data.entity_tokens[nl])
        yield {"pos_pairs": pos_pairs, "neg_pairs": neg_pairs, "first_segment_end": lm}


def distill_triplet_batches(
    data: EntLinkDataset,
    num_pos_labels: int,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    input_embeds: Optional[np.ndarray] = None,
    label_embeds: Optional[np.ndarray] = None,
    drop_remainder: bool = False,
    pad_remainder: bool = True,
    device: DeviceLike = "cuda",
) -> Iterator[Dict[str, np.ndarray]]:
    """Triplet-style distillation (reference neg_strategy
    'top_ce_w_bienc_hard_negs_trp' / 'top_ce_w_rand_negs_trp',
    data_process.py:810-860): each of a mention's top-``num_pos_labels``
    teacher-CE labels becomes a (mention, pos, neg) triplet, negatives
    mined per mention with the current bi-encoder towers' embeddings
    (MIPS on ``device``) while treating ALL top-CE labels as positives
    (random-with-blacklist when no embeddings are given). Yields bi-encoder
    batches with a single negative: {'input': (b,Lm), 'pos': (b,Le),
    'negs': (b,1,Le)}."""
    if data.score_matrix is None:
        raise ValueError("triplet distillation requires a teacher score matrix")
    top = negs_mod.get_precomputed_ents_w_scores(data.score_matrix, num_pos_labels)
    pos_idx = top["indices"]  # (n_m, P)
    if input_embeds is not None and label_embeds is not None:
        neg_idx = negs_mod.get_hard_negs_from_embeds_w_blacklist(
            input_embeds, label_embeds, pos_idx, num_pos_labels, device
        )
    else:
        neg_idx = negs_mod.get_random_negs_w_blacklist(
            data.gt_labels, pos_idx, data.n_ents, num_pos_labels, seed
        )
    # expand to n_m * P triplets (reference :833-845)
    ment_rows = np.repeat(np.arange(data.n_ments), num_pos_labels)
    pos_flat = pos_idx.reshape(-1)
    neg_flat = neg_idx.reshape(-1)
    order = _batch_order(len(ment_rows), shuffle, seed)
    for idx in _batch_indices(order, batch_size, drop_remainder, pad_remainder):
        yield {
            "input": data.mention_tokens[ment_rows[idx]],
            "pos": data.entity_tokens[pos_flat[idx]],
            "negs": data.entity_tokens[neg_flat[idx]][:, None, :],
        }


def distill_batches(
    data: EntLinkDataset,
    top_n_labels: int,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
    pad_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'input': (b,Lm), 'labels': (b,N,Le), 'target_scores': (b,N)}
    for bi-encoder distillation from teacher CE scores (reference
    'top_ce_match' dataset, data_process.py:706-868)."""
    if data.score_matrix is None:
        raise ValueError("distillation requires a teacher score matrix")
    top = negs_mod.get_precomputed_ents_w_scores(data.score_matrix, top_n_labels)
    order = _batch_order(data.n_ments, shuffle, seed)
    for idx in _batch_indices(order, batch_size, drop_remainder, pad_remainder):
        yield {
            "input": data.mention_tokens[idx],
            "labels": data.entity_tokens[top["indices"][idx]],
            "target_scores": top["scores"][idx],
        }
