"""Negative-mining strategies.

Counterpart of ``anncur_tpu/train/negatives.py`` (parity with reference
utils/data_process.py:272-463): random negatives (excluding the
positive), random with blacklist, bi-encoder hard negatives (exact MIPS
over current tower embeddings: kernel B on the card,
``ops/mips_kernel.py::mips_topk_fused``, its plain ``mips_topk`` for CPU
tensors; ties go to the lowest index as ``lax.top_k``'s do), TF-IDF hard
negatives (the same miner over dense tf-idf rows as wide as the corpus
vocabulary), and precomputed negatives with scores (for distillation
datasets).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from anncur_tpu_torch.data.tfidf import TfidfVectorizer
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device


def get_random_negs(
    gt_labels: np.ndarray,  # (b,)
    n_labels: int,
    num_negs: int,
    seed: int,
) -> np.ndarray:
    """(b, num_negs) uniform negatives excluding each row's positive
    (reference: get_random_negs, utils/data_process.py:272-294)."""
    rng = np.random.default_rng(seed)
    out = np.empty((len(gt_labels), num_negs), np.int64)
    for i, gt in enumerate(gt_labels):
        pool = np.concatenate([np.arange(gt), np.arange(gt + 1, n_labels)])
        out[i] = rng.choice(pool, size=num_negs, replace=num_negs > len(pool))
    return out


def get_random_negs_w_blacklist(
    gt_labels: np.ndarray,
    blacklists: Sequence[Sequence[int]],  # per-row excluded label ids
    n_labels: int,
    num_negs: int,
    seed: int,
) -> np.ndarray:
    """(reference: get_random_negs_w_blacklist, :297-317), with a boolean
    mask per row, as the JAX package's copy."""
    rng = np.random.default_rng(seed)
    out = np.empty((len(gt_labels), num_negs), np.int64)
    all_labels = np.arange(n_labels)
    for i, gt in enumerate(gt_labels):
        mask = np.ones(n_labels, dtype=bool)
        mask[np.asarray(blacklists[i], dtype=np.int64)] = False
        mask[int(gt)] = False
        pool = all_labels[mask]
        out[i] = rng.choice(pool, size=num_negs, replace=num_negs > len(pool))
    return out


def _mips(input_embeds, label_embeds, k: int, device: DeviceLike) -> Tuple[np.ndarray, np.ndarray]:
    """(scores, ids) of the exact top-``k`` on ``device`` (kernel B on the card)."""
    dev = resolve_device(device)
    queries = torch.as_tensor(np.ascontiguousarray(input_embeds, np.float32), device=dev)
    items = torch.as_tensor(np.ascontiguousarray(label_embeds, np.float32), device=dev)
    scores, ids = mips_topk_fused(queries, items, k)
    return scores.cpu().numpy(), ids.cpu().numpy()


def _drop_gold(idx: np.ndarray, gt_labels: np.ndarray, num_negs: int) -> np.ndarray:
    """The first ``num_negs`` non-gold ids of each top-k row."""
    out = np.empty((len(gt_labels), num_negs), np.int64)
    for i, gt in enumerate(gt_labels):
        row = [j for j in idx[i] if j != gt][:num_negs]
        while len(row) < num_negs:  # pad if gold occupied a slot and k small
            row.append(row[-1] if row else 0)
        out[i] = row
    return out


def get_hard_negs_from_embeds(
    input_embeds: np.ndarray,  # (b, d)
    label_embeds: np.ndarray,  # (n, d)
    gt_labels: np.ndarray,  # (b,)
    num_negs: int,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Top-scoring non-gold labels under an embedding model — the
    bi-encoder hard-negative miner (reference: get_hard_negs_biencoder,
    utils/data_process.py:320-370; FAISS -> exact MIPS on ``device``)."""
    k = min(num_negs + 1, label_embeds.shape[0])
    return _drop_gold(_mips(input_embeds, label_embeds, k, device)[1], gt_labels, num_negs)


def get_hard_negs_from_embeds_w_blacklist(
    input_embeds: np.ndarray,  # (b, d)
    label_embeds: np.ndarray,  # (n, d)
    blacklists,  # per-row excluded label ids (e.g. top-CE positives)
    num_negs: int,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Bi-encoder hard negatives with a per-row positive-set blacklist
    (reference: get_hard_negs_biencoder called with pos_label_idxs =
    top-CE labels, utils/data_process.py:822-831)."""
    n_labels = label_embeds.shape[0]
    k = min(num_negs + max(len(b) for b in blacklists), n_labels)
    idx = _mips(input_embeds, label_embeds, k, device)[1]
    out = np.empty((len(blacklists), num_negs), np.int64)
    for i, banned in enumerate(blacklists):
        banned = set(int(b) for b in banned)
        row = [j for j in idx[i] if j not in banned][:num_negs]
        while len(row) < num_negs:
            row.append(row[-1] if row else 0)
        out[i] = row
    return out


def tfidf_topk(
    mention_texts: Sequence[str],
    entities: Sequence[Tuple[str, str]],
    k: int,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores, ids) of the top-``k`` entities of each mention text under
    TF-IDF (reference: utils/compute_tfidf_hard_negs.py): a vectorizer
    fitted on the entity corpus embeds both sides into dense rows as wide
    as its vocabulary, mined by the exact MIPS on ``device``."""
    corpus = [f"{t} {d}" for t, d in entities]
    vec = TfidfVectorizer().fit(corpus)
    return _mips(vec.transform(mention_texts), vec.transform(corpus), k, device)


def get_hard_negs_tfidf(
    mention_texts: Sequence[str],
    entities: Sequence[Tuple[str, str]],
    gt_labels: np.ndarray,
    num_negs: int,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """TF-IDF hard negatives (reference: get_hard_negs_tfidf, :373-407):
    the :func:`tfidf_topk` rows less the gold, as
    :func:`get_hard_negs_from_embeds` keeps them."""
    k = min(num_negs + 1, len(entities))
    return _drop_gold(tfidf_topk(mention_texts, entities, k, device)[1], gt_labels, num_negs)


def get_precomputed_ents_w_scores(
    score_matrix: np.ndarray,  # (b, n) teacher CE scores per mention
    top_n: int,
) -> Dict[str, np.ndarray]:
    """Top-N labels + scores per mention for distillation datasets
    (reference: get_precomputed_ents_w_scores, :426-463 and the
    'top_ce_match' neg strategy)."""
    order = np.argsort(-score_matrix, axis=1)[:, :top_n]
    scores = np.take_along_axis(score_matrix, order, axis=1)
    return {"indices": order, "scores": scores}
