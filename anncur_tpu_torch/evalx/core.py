"""Shared retrieve-then-rerank evaluation primitives, vectorized.

Counterpart of ``anncur_tpu/evalx/core.py``. The reference's evaluators
loop per mention in Python, mask-fill a score vector at -1e14 and top-k it
(run_retrieval_eval_wrt_exact_crossenc.py:97-117); here one gather and two
top-k calls rank every mention at once, with the same semantics (only
retrieved entities can appear in the reranked list). The (q, n) matrices
stay on their device; the top-k is ``topk_stable`` (ties to the lowest
index, as ``lax.top_k``).

Ties: an exact-score tie among retrieved items goes to the lowest item id,
as in the reference's masked top-k over all items and in the host grid
evaluator's stable argsorts, so :func:`eval_approx_grid` equals the
per-point evaluator on tied matrices too (the trained-CE matrices are
float16). JAX's ``retrieve_rerank`` gathers in retrieval order and gives
such a tie to the item retrieved first; the two agree wherever the exact
scores of a row's retrieved items are distinct.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from anncur_tpu_torch.core.adaptive_fused import take_per_row
from anncur_tpu_torch.core.metrics import frobenius_error, topk_overlap_frac
from anncur_tpu_torch.ops.mips import topk_stable
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device


def on_device(x, device: Optional[DeviceLike] = None) -> torch.Tensor:
    """``x`` (numpy or tensor) as an f32 tensor on ``device``; None keeps a
    tensor where it is and puts numpy on the card."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    dev = resolve_device(device)
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def to_host(x) -> np.ndarray:
    """``x`` as a numpy array (one copy off the device for a tensor)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def retrieve_rerank(
    exact: torch.Tensor,  # (q, n) exact scores
    approx: torch.Tensor,  # (q, n) approximate scores, on exact's device
    top_k: int,
    top_k_retvr: int,
) -> Dict[str, torch.Tensor]:
    """Exact top-k, approx top-k_retvr, and the reranked top-k (the
    approx retrieval reranked by exact scores, ties to the lowest item id),
    all on the inputs' device."""
    exact_scores, exact_idx = topk_stable(exact, top_k)
    approx_scores, approx_idx = topk_stable(approx, top_k_retvr)
    by_id = approx_idx.sort(dim=1).values  # the retrieved set in id order
    rr_scores, rr_pos = topk_stable(take_per_row(exact, by_id), top_k)
    return {
        "exact_indices": exact_idx,
        "exact_scores": exact_scores,
        "approx_indices": approx_idx,
        "approx_scores": approx_scores,
        "reranked_indices": torch.gather(by_id, 1, rr_pos),
        "reranked_scores": rr_scores,
    }


def _stats(vals: Dict[str, np.ndarray]) -> Dict[str, float]:
    out = {}
    for name, v in vals.items():
        for stat, fn in (("mean", np.mean), ("std", np.std), ("p50", lambda x: np.percentile(x, 50))):
            out[f"exact_vs_reranked_approx_retvr~{name}_{stat}"] = float(fn(v)) if len(v) else 0.0
    return out


def _frac_stats(frac: np.ndarray, k: int) -> Dict[str, float]:
    """Flat metric dict in the reference's key format
    (exact_vs_reranked_approx_retvr~common_frac_mean etc.,
    run_retrieval_eval_wrt_exact_crossenc.py:124-144)."""
    return _stats({
        "common": frac * k,
        "diff": (1 - frac) * k,
        # reference total = k (its n_total = len1+len2 is dead code,
        # eval/eval_utils.py:143-149)
        "total": np.full_like(frac, float(k)),
        "common_frac": frac,
        "diff_frac": 1 - frac,
    })


def _overlap_stats(a: np.ndarray, b: np.ndarray, k: int) -> Dict[str, float]:
    """The overlap metrics of the top-k of two (q, >=k) index arrays."""
    a, b = np.asarray(a)[:, :k], np.asarray(b)[:, :k]
    frac = topk_overlap_frac(a, b).numpy() if len(a) else np.zeros((0,), np.float32)
    return _frac_stats(frac, k)


def eval_approx_for_all_topk(
    exact,
    approx,
    top_k_vals: Sequence[int],
    top_k_retvr: int,
    with_error: bool = False,
    device: Optional[DeviceLike] = None,
) -> Dict[int, Dict[str, float]]:
    """One retrieval at ``top_k_retvr`` on ``device``, evaluated at every
    top_k <= top_k_retvr (reference: eval_approx_score_mat_for_all_topk,
    ..._w_fixed_train_test_splits.py:51-132)."""
    top_k_vals = [k for k in top_k_vals if k <= top_k_retvr]
    if not top_k_vals:
        return {}
    exact = on_device(exact, device)
    approx = on_device(approx, exact.device)
    n = exact.shape[1]
    out = retrieve_rerank(exact, approx, min(max(top_k_vals), n), min(top_k_retvr, n))
    exact_idx, rr_idx = to_host(out["exact_indices"]), to_host(out["reranked_indices"])
    res = {}
    for k in top_k_vals:
        res[k] = _overlap_stats(exact_idx, rr_idx, k)
        if with_error:
            res[k].update(frobenius_error(approx, exact))
    return res


def _split_eval_device(exact: torch.Tensor, approx: torch.Tensor, top_k: int, top_k_retvr: int) -> np.ndarray:
    """The device half of :func:`eval_split_overlap`: the exact and the
    reranked top-k ids and each row's squared error and squared norm (f32
    sums), packed as f64 columns (ids are exact below 2**53) and read back
    in one copy; the (q, n) matrices never leave the device."""
    out = retrieve_rerank(exact, approx, top_k, top_k_retvr)
    row_sq_err = ((approx - exact) ** 2).sum(1)
    row_sq_base = (exact ** 2).sum(1)
    packed = torch.cat(
        [out["exact_indices"].double(), out["reranked_indices"].double(),
         row_sq_err.double()[:, None], row_sq_base.double()[:, None]], dim=1,
    )
    return to_host(packed)


def eval_split_overlap(
    exact,
    approx,
    top_k: int,
    top_k_retvr: int,
    ment_splits: Dict[str, np.ndarray],
    device: Optional[DeviceLike] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-mention-split (anchor / non_anchor / all) overlap and Frobenius
    error (reference: run_approx_eval_w_seed, :124-154). ``exact`` and
    ``approx`` may be tensors; they stay on ``device`` (default: exact's)."""
    exact = on_device(exact, device)
    approx = on_device(approx, exact.device)
    n = exact.shape[1]
    k = min(top_k, n)
    packed = _split_eval_device(exact, approx, k, min(top_k_retvr, n))
    exact_idx = packed[:, :k].astype(np.int64)
    rr_idx = packed[:, k: 2 * k].astype(np.int64)
    row_sq_err, row_sq_base = packed[:, 2 * k], packed[:, 2 * k + 1]
    res = {}
    for name, idxs in ment_splits.items():
        stats = _overlap_stats(exact_idx[idxs], rr_idx[idxs], k)
        err = float(np.sqrt(row_sq_err[idxs].sum()))
        base = float(np.sqrt(row_sq_base[idxs].sum()))
        stats["approx_error"] = err
        stats["approx_error_relative"] = err / max(base, 1e-30)
        res[name] = stats
    return res


def eval_approx_grid(
    exact: np.ndarray,
    approx: np.ndarray,
    top_k_vals: Sequence[int],
    top_k_retvr_vals: Sequence[int],
    with_error: bool = False,
) -> Dict[int, Dict[int, Dict[str, float]]]:
    """{top_k_retvr: {top_k: stats}} for a whole retrieval grid from two
    host argsorts.

    Reranking the approx top-kr by exact scores makes the reranked top-k
    the k best-exact-ranked items of the retrieved set, so overlap@k with
    the exact top-k is the count of retrieved items whose exact rank is
    < k: one (q, n) rank gather serves every (k, kr) pair. The argsorts
    are stable, so ties break by item id as in :func:`retrieve_rerank`."""
    exact = to_host(exact)
    approx = to_host(approx)
    q, n = exact.shape
    top_k_retvr_vals = [kr for kr in top_k_retvr_vals if 1 <= kr <= n]
    if not top_k_retvr_vals:
        return {}
    # exact rank of every item, then those ranks in approx-retrieval order
    exact_order = np.argsort(-exact, axis=1, kind="stable")
    rank = np.empty((q, n), np.int64)
    np.put_along_axis(rank, exact_order, np.arange(n)[None, :], axis=1)
    approx_order = np.argsort(-approx, axis=1, kind="stable")
    retrieved_ranks = np.take_along_axis(rank, approx_order, axis=1)  # (q, n)

    err = frobenius_error(approx, exact) if with_error else None
    out: Dict[int, Dict[int, Dict[str, float]]] = {}
    for k in sorted(set(int(k) for k in top_k_vals)):
        if k > n:
            continue
        hits = np.cumsum(retrieved_ranks < k, axis=1)  # (q, n)
        for kr in top_k_retvr_vals:
            if k > kr:
                continue
            stats = _frac_stats(hits[:, kr - 1] / float(k), k)
            if err is not None:
                stats.update(err)
            out.setdefault(kr, {})[k] = stats
    return out
