"""AXN-style indexing: factorized item embeddings + online regression.

Counterpart of ``anncur_tpu/core/axn.py`` (after arXiv 2405.03651):

offline:  fit rank-r item embeddings E (n_items, r) from the train score
          matrix, M - mu ~= U S Vᵀ, E = V_r S_r (an f64 SVD on the host,
          once per cache fill);
online:   a query that scored the items S solves the ridge problem
              q* = argmin_q ||s_S - mu_S - q E_Sᵀ||² + lam ||q||²
          and its approximate scores for all items are q* Eᵀ + mu.

Singular vectors are defined up to sign, and up to a rotation inside a
repeated singular value, so two fits need not give the same E; the
completion q* Eᵀ + mu does not depend on that choice (the ridge with lam
I is invariant under an orthogonal change of basis). Compare completions
and picks, never embeddings.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Tuple

import numpy as np
import torch

from anncur_tpu_torch.utils.device import DeviceLike, resolve_device, true_f32


@dataclasses.dataclass(frozen=True)
class AxnIndex:
    item_embeds: torch.Tensor  # (n_items, r) f32
    mean: torch.Tensor  # (n_items,) f32 per-item train-score mean

    @property
    def rank(self) -> int:
        return self.item_embeds.shape[1]


def fit_item_embeddings(train_scores, rank: int, center: bool = True, device: DeviceLike = "cuda") -> AxnIndex:
    """Truncated SVD of the (centred) train matrix in f64 on the host:
    item embeddings = V_r S_r, so queries live in the left-singular space
    with unit covariance. ``train_scores``: (n_train, n_items) array or
    tensor; the index lands on ``device``."""
    dev = resolve_device(device)
    if torch.is_tensor(train_scores):
        train_scores = train_scores.detach().cpu().numpy()
    m = np.asarray(train_scores, np.float64)
    mu = m.mean(axis=0) if center else np.zeros(m.shape[1])
    rank = min(rank, min(m.shape))
    _, s, vt = np.linalg.svd(m - mu[None, :], full_matrices=False)
    item_embeds = (vt[:rank].T * s[:rank][None, :]).astype(np.float32)
    return AxnIndex(
        item_embeds=torch.as_tensor(item_embeds, device=dev),
        mean=torch.as_tensor(mu.astype(np.float32), device=dev),
    )


_CACHE_MAX = 4
_FIT_CACHE: dict = {}  # (content digest, rank, center, device) -> AxnIndex
_TENSOR_DIGESTS: dict = {}  # id(tensor) -> (weakref, version counter, content digest)


def _host_f32(train_scores) -> np.ndarray:
    """A contiguous f32 host copy of an array or tensor."""
    if torch.is_tensor(train_scores):
        train_scores = train_scores.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(train_scores, np.float32))


def _remember(cache: dict, key, value) -> None:
    """Insert into a cache of at most _CACHE_MAX entries, oldest out first."""
    if key not in cache and len(cache) >= _CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = value


def fit_item_embeddings_cached(
    train_scores, rank: int, center: bool = True, device: DeviceLike = "cuda"
) -> AxnIndex:
    """:func:`fit_item_embeddings` memoised by content (blake2b of the f32
    bytes), at most 4 fits: a refreshed matrix of the same shape must not
    return a stale fit, while sweeps that refit one matrix at every
    (budget, seed) skip the f64 SVD.

    Hashing needs the matrix on the host. A tensor passed again unchanged
    (the same object, its version counter not moved by an in-place edit)
    reuses its digest, so a train matrix that a server keeps on the card
    and passes at every call is copied to the host once, not per call."""
    dev = resolve_device(device)
    arr = digest = None
    if torch.is_tensor(train_scores):
        seen = _TENSOR_DIGESTS.get(id(train_scores))
        # torch counts in-place edits in the private Tensor._version
        if seen is not None and seen[0]() is train_scores and seen[1] == train_scores._version:
            digest = seen[2]
    if digest is None:
        arr = _host_f32(train_scores)
        digest = (hashlib.blake2b(arr.tobytes(), digest_size=16).digest(), arr.shape)
        if torch.is_tensor(train_scores):
            _remember(_TENSOR_DIGESTS, id(train_scores),
                      (weakref.ref(train_scores), train_scores._version, digest))
    key = (digest, rank, center, str(dev))
    if key not in _FIT_CACHE:
        _remember(_FIT_CACHE, key, fit_item_embeddings(_host_f32(train_scores) if arr is None else arr,
                                                       rank, center, dev))
    return _FIT_CACHE[key]


def axn_complete(
    index: AxnIndex,
    scored_item_ids: torch.Tensor,  # (k,) int
    scored_values: torch.Tensor,  # (q, k) exact CE scores at those items
    lam: float = 1e-3,
) -> torch.Tensor:
    """(q, n_items) approximate scores: one ridge regression shared by the
    batch's queries on the observed entries, in true f32."""
    ids = torch.as_tensor(scored_item_ids, device=index.item_embeds.device).long()
    vals = torch.as_tensor(scored_values, device=index.item_embeds.device).float()
    e_s = index.item_embeds[ids]  # (k, r)
    y = vals - index.mean[ids][None, :]
    r = index.rank
    with true_f32():
        gram = e_s.T @ e_s + lam * torch.eye(r, dtype=torch.float32, device=e_s.device)
        q_emb = torch.linalg.solve(gram, e_s.T @ y.T).T  # (q, r)
        return q_emb @ index.item_embeds.T + index.mean[None, :]


def axn_query(
    index: AxnIndex,
    score_items_fn,
    n_items: int,
    total_budget: int,
    n_rounds: int = 2,
    top_k: int = 10,
    lam: float = 1e-3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Adaptive AXN retrieval: the host round loop of
    ``core/adaptive.py::adaptive_cur_query`` (budget split, shared round 0,
    union scoring, exhaustion, -1 fill) completing through the embedding
    space. Returns (scores (q, top_k), ids (q, top_k)) as numpy."""
    # core/adaptive.py imports this module (through core/adaptive_fused.py)
    from anncur_tpu_torch.core.adaptive import adaptive_cur_query

    def complete(ids, vals):
        return axn_complete(index, torch.as_tensor(np.asarray(ids)), torch.as_tensor(np.asarray(vals, np.float32)),
                            lam).cpu().numpy()

    out_scores, out_ids, _ = adaptive_cur_query(
        None, score_items_fn, n_items=n_items, total_budget=total_budget, n_rounds=n_rounds,
        top_k=top_k, seed=seed, complete_fn=complete,
    )
    return out_scores, out_ids
