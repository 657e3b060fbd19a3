"""Entity-to-anchor-entity score matrices for the fixed-anchor-entity
baselines.

Counterpart of ``anncur_tpu/indexer/ent2ent.py``. The reference consumes
pickles named ``ent_to_ent_scores_n_e_{N}x{N}_topk_{K}_embed_bienc_m2e_
bienc_cluster.pkl`` holding {'ent_to_ent_scores': (n_ents, K),
'topk_ents': (1, K)} (eval/run_retrieval_eval_wrt_exact_crossenc.py:
288-346) but never ships the producer. This module is that producer:
anchor entities are cluster representatives of bi-encoder entity
embeddings (k-means++ seeding, 'bienc_cluster' in the reference naming),
and each entity is scored against every anchor with the cross-encoder
through the port's ``ScoreMatrixBuilder`` (entity ⧺ entity pairs,
kernel A on the card). The pickle schema is the JAX package's.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Tuple

import numpy as np

from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder

LOGGER = logging.getLogger(__name__)


def kmeanspp_anchor_ids(embeds: np.ndarray, n_anchors: int, seed: int = 0) -> np.ndarray:
    """k-means++ seeding: far-apart representatives of the embedding set
    (a copy of the JAX package's, numpy throughout).

    n_anchors <= 0 returns an empty array; when every remaining point
    duplicates a chosen one (fewer distinct embeddings than anchors asked
    for) the remaining slots take the lowest unchosen indices."""
    rng = np.random.default_rng(seed)
    n = embeds.shape[0]
    n_anchors = min(n_anchors, n)
    if n_anchors <= 0:
        return np.zeros((0,), np.int64)
    chosen = [int(rng.integers(n))]
    d2 = np.full(n, np.inf)
    for _ in range(n_anchors - 1):
        last = embeds[chosen[-1]]
        d2 = np.minimum(d2, np.sum((embeds - last) ** 2, axis=1))
        total = float(d2.sum())
        if total <= 0.0:
            break  # only duplicates remain
        chosen.append(int(rng.choice(n, p=d2 / total)))
    uniq = sorted(set(chosen))
    if len(uniq) < n_anchors:
        fill = (i for i in range(n) if i not in set(uniq))
        uniq += [next(fill) for _ in range(n_anchors - len(uniq))]
    return np.asarray(sorted(uniq), np.int64)


def build_ent_to_ent_scores(
    builder: ScoreMatrixBuilder,
    ent_tokens: np.ndarray,  # (n_e, Le)
    anchor_ids: np.ndarray,  # (k,)
) -> np.ndarray:
    """(n_ents, k) cross-encoder scores of every entity (as 'query') against
    each anchor entity (as 'item'): pair = entity ⧺ anchor[1:]. The
    builder holds its CE (the JAX version passes its params here)."""
    return builder(ent_tokens, ent_tokens[np.asarray(anchor_ids)])


def save_ent_to_ent_pickle(path: str, ent_to_ent_scores: np.ndarray, anchor_ids: np.ndarray) -> None:
    """The reference's pickle schema (scores, and topk_ents with a leading
    broadcast dim, run_retrieval_eval_wrt_exact_crossenc.py:299-302)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fout:
        pickle.dump(
            {
                "ent_to_ent_scores": np.asarray(ent_to_ent_scores),
                "topk_ents": np.asarray(anchor_ids)[None, :],
            },
            fout,
        )


def load_ent_to_ent_pickle(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(scores (n_ents, k), anchor ids (k,)) of a file of either package
    (or the reference's, with torch tensors)."""
    with open(path, "rb") as fin:
        data = pickle.load(fin)
    scores = data["ent_to_ent_scores"]
    if hasattr(scores, "numpy"):
        scores = scores.numpy()
    anchors = np.asarray(data["topk_ents"])[0]
    return np.asarray(scores), anchors
