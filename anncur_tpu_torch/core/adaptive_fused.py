"""Adaptive multi-round CUR retrieval on one GPU.

Counterpart of ``anncur_tpu/core/adaptive_fused.py`` (ADACUR-style,
arXiv 2305.02996). Each query spends its CE-call budget in rounds: round
0 scores shared anchor items; every later round completes the query's
scores over all items from the ones it has (a batched ridge solve in the
train matrix's latent space), picks its ``per`` best unscored items and
scores them exactly; the answer is the top-k of the exact scores.

The per-query pseudoinverse is a ridge solve through the push-through
identity ``vals @ pinv(C) @ train == vals @ (CᵀC + λI)⁻¹ Cᵀ @ train``
(λ → 0), with C the train matrix's columns at the query's scored ids and
λ relative to the Gram trace (``ridge_rel``, the pinv-rcond role).

On the card the product ``w @ train`` is never formed for a pick: the
(q, n_train) weights ``w`` go to kernel B (``ops/mips_kernel.py``) as
queries against the train matrix held transposed, with the query's
scored ids as its exclusion list. One pick of ``per`` replaces the JAX
engine's tiled sub-picks (``ROUND_WIDTH_CAP``, a TPU-worker workaround):
with ties to the lowest id the two pick the same ids in the same order.
Kernel B never picks an id >= n_valid and refuses k > n_valid - S, which
stands in for the JAX engine's masking of padded columns: a query cannot
run out of real candidates while the budget is clamped to the item count.

``method="axn"`` completes through factorized item embeddings instead
(``core/axn.py``): a query's latent embedding solves an (r x r) ridge
system on its own scored items, and its completion is ``q_emb Eᵀ +
mean``. Kernel B gets that product too, never the (q, n) completion: the
queries ``[q_emb, 1]`` (q, r+1) against the items ``[E, mean]`` (n_pad,
r+1), built once per call, so the mean comes last in each fmaf chain, as
JAX adds it after the sum. Both completers hand ``_grow_rounds`` the same
thing, kernel B's (queries, items) pair (:class:`CurCompleter`,
:class:`AxnCompleter`).

The Grams, the solves and the query side run in true f32 (TF32 off: it
collapses recall, as reduced matmul precision did on the TPU); the solves
check nothing on the host. Entry points take ``device="cuda"`` and raise
without it; tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from anncur_tpu_torch.core.axn import AxnIndex, fit_item_embeddings_cached
from anncur_tpu_torch.core.metrics import topk_overlap_frac
from anncur_tpu_torch.ops.mips import topk_stable
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device
from anncur_tpu_torch.utils.device import true_f32 as _true_f32

ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # ids (q, w) int64 -> (q, w) f32 exact scores


def _check_method(method: str) -> None:
    if method not in ("cur", "axn"):
        raise ValueError(f"method={method!r} not in ('cur', 'axn')")


def split_rounds(total_budget: int, n_rounds: int) -> Tuple[int, int, int]:
    """(first_round, per_round, n_rounds) with the same split as
    core/adaptive.py::adaptive_cur_query: later rounds get
    budget//n_rounds each, round 0 the remainder."""
    n_rounds = max(1, min(n_rounds, total_budget))
    per_round = max(1, total_budget // n_rounds)
    first_round = total_budget - per_round * (n_rounds - 1)
    return first_round, per_round, n_rounds


def take_per_row(mat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``mat[q, ids[q]]``: a ``torch.gather`` on int64 indices, so the
    JAX version's int32 flat-index overflow guard has nothing to guard."""
    return torch.gather(mat, 1, ids.long())


def ridge_weights(
    train_t: torch.Tensor,  # (m, n_train) f32: the train matrix, transposed
    ids: torch.Tensor,  # (q, S) per-query scored item ids
    vals: torch.Tensor,  # (q, S) exact scores at those ids
    ridge_rel: float = 1e-6,
) -> torch.Tensor:
    """(q, n_train) f32 weights w with ``w @ train`` the ridge completion
    of each query's scores: c = train columns at its ids (rows of
    ``train_t``), z = (c cᵀ + λI)⁻¹ vals with λ = ridge_rel · trace/S,
    w = zᵀ c. The solve checks nothing on the host (no device sync)."""
    s = ids.shape[1]
    c = train_t[ids]  # (q, S, n_train)
    with _true_f32():
        gram = torch.bmm(c, c.transpose(1, 2))  # (q, S, S)
        lam = ridge_rel * (gram.diagonal(dim1=1, dim2=2).sum(-1) / s)
        gram = gram + lam[:, None, None] * torch.eye(s, dtype=gram.dtype, device=gram.device)
        z = torch.linalg.solve_ex(gram, vals.float()[..., None])[0]  # (q, S, 1)
        return torch.bmm(z.transpose(1, 2), c)[:, 0]


def ridge_complete(
    train_t: torch.Tensor,  # (m, n_train) f32: the train matrix, transposed
    ids: torch.Tensor,
    vals: torch.Tensor,
    ridge_rel: float = 1e-6,
    cols: Optional[torch.Tensor] = None,  # (L,) complete only these columns
) -> torch.Tensor:
    """(q, m) approximate all-item scores, or (q, L) at ``cols``: the
    counterpart of JAX's ``ridge_complete(train, ...)``, taking the train
    matrix transposed as the engine holds it. The engine itself forms
    this product only where it needs every column (a shortlist's pool)."""
    w = ridge_weights(train_t, ids, vals, ridge_rel)
    out = train_t if cols is None else train_t[cols]
    with _true_f32():
        return w @ out.T


def axn_query_side(
    item_embeds: torch.Tensor,  # (m, r) factorized item embeddings (core/axn.py)
    mean: torch.Tensor,  # (m,) per-item train-score mean
    ids: torch.Tensor,  # (q, S) per-query scored item ids
    vals: torch.Tensor,  # (q, S) exact scores at those ids
    lam_rel: float = 1e-2,
    dim_cap_frac: Optional[float] = None,
) -> torch.Tensor:
    """(q, r+1) f32 ``[q_emb, 1]``: each query's latent embedding solves
    (E_Sᵀ E_S + λI) q_emb = E_Sᵀ (vals - mean_S) on its own scored items,
    λ = lam_rel · trace/r, in true f32 with no host check. Against the
    items ``[E, mean]`` it gives the AXN completion.

    ``dim_cap_frac`` (JAX's closed probe, kept as a knob, default None):
    solve in the first d = min(r, max(1, int(S · frac))) dims only; the
    other entries of q_emb are 0."""
    r = item_embeds.shape[1]
    d = r if dim_cap_frac is None else min(r, max(1, int(ids.shape[1] * dim_cap_frac)))
    e_s = item_embeds[ids][:, :, :d]  # (q, S, d)
    y = vals.float() - mean[ids]
    with _true_f32():
        gram = torch.bmm(e_s.transpose(1, 2), e_s)  # (q, d, d)
        lam = lam_rel * (gram.diagonal(dim1=1, dim2=2).sum(-1) / d)
        gram = gram + lam[:, None, None] * torch.eye(d, dtype=gram.dtype, device=gram.device)
        rhs = torch.bmm(e_s.transpose(1, 2), y[..., None])  # (q, d, 1)
        q_emb = torch.linalg.solve_ex(gram, rhs)[0][..., 0]
    out = q_emb.new_zeros((ids.shape[0], r + 1))
    out[:, :d] = q_emb
    out[:, r] = 1.0
    return out


def axn_item_side(index: AxnIndex, n_pad: int) -> torch.Tensor:
    """(n_pad, r+1) f32 contiguous ``[E, mean]``, rows past the index's
    items zero: kernel B's items for an AXN pick."""
    n, r = index.item_embeds.shape
    items = index.item_embeds.new_zeros((n_pad, r + 1))
    items[:n, :r] = index.item_embeds
    items[:n, r] = index.mean
    return items


def axn_complete_batched(
    item_embeds: torch.Tensor,  # (m, r)
    mean: torch.Tensor,  # (m,)
    ids: torch.Tensor,  # (q, S) per-query scored item ids
    vals: torch.Tensor,  # (q, S)
    lam_rel: float = 1e-2,
    dim_cap_frac: Optional[float] = None,
    cols: Optional[torch.Tensor] = None,  # (L,) complete only these columns
) -> torch.Tensor:
    """(q, m) AXN completion with per-query scored sets, or (q, L) at
    ``cols``: ``q_emb Eᵀ + mean`` in true f32, the counterpart of JAX's
    ``axn_complete_batched``. The engine forms it only where it needs every
    column (a shortlist's pool)."""
    w = axn_query_side(item_embeds, mean, ids, vals, lam_rel, dim_cap_frac)
    items = torch.cat([item_embeds, mean[:, None]], dim=1)
    items = items if cols is None else items[cols]
    with _true_f32():
        return w @ items.T


class CurCompleter:
    """CUR completion for the engine: kernel B's items are the train
    matrix held transposed (n_pad, n_train), its queries each query's ridge
    weights ``w`` (:func:`ridge_weights`)."""

    def __init__(self, train_t: torch.Tensor, ridge_rel: float = 1e-6):
        self.items, self.ridge_rel = train_t, ridge_rel

    def queries(self, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return ridge_weights(self.items, ids, vals, self.ridge_rel)


class AxnCompleter:
    """AXN completion for the engine: kernel B's items are ``[E, mean]``
    (:func:`axn_item_side`), its queries ``[q_emb, 1]``
    (:func:`axn_query_side`)."""

    def __init__(self, index: AxnIndex, n_pad: int, lam_rel: float = 1e-2):
        self.index, self.lam_rel = index, lam_rel
        self.items = axn_item_side(index, n_pad)

    def queries(self, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return axn_query_side(self.index.item_embeds, self.index.mean, ids, vals, self.lam_rel)


def _grow_rounds(
    score_fn: ScoreFn,
    completer,  # CurCompleter | AxnCompleter: kernel B's (queries, items)
    ids: torch.Tensor,  # (q, width) int64 buffer; columns [0, filled) are scored
    vals: torch.Tensor,  # (q, width) f32 buffer
    filled: int,
    n_new_rounds: int,
    per: int,
    n_valid: int,
    shortlist: Optional[int] = None,
) -> int:
    """Extend each query's scored state, in place, by ``n_new_rounds``
    rounds of ``per`` candidates: complete -> pick the unscored top-``per``
    (kernel B, the scored ids excluded) -> exact-score -> append. Returns
    the new filled width. Shared by the from-scratch engine and the
    early-stop continuation (the state is the resume point).

    ``shortlist`` (L) bounds the per-round work at large corpora: the first
    round here forms the full completion (a plain f32 matmul of the
    completer's queries and items, as JAX forms it outside any kernel),
    picks from it and freezes the batch's pool to
    the top-L columns of its max over queries, every scored id forced in
    (an id-unique pool: a per-query union could repeat a column); later
    rounds run kernel B over the pool's item rows, gathered once, with
    the exclusions mapped to pool slots (-1 outside it). Callers keep L >=
    every scored id plus the remaining picks (the retriever clamps)."""
    use_shortlist = shortlist is not None and n_new_rounds >= 2 and shortlist < n_valid
    sl_ids = sl_items = loc = None
    items = completer.items
    for _ in range(n_new_rounds):
        scored = ids[:, :filled]
        w = completer.queries(scored, vals[:, :filled])
        if use_shortlist and sl_ids is None:
            with _true_f32():
                approx = w @ items.T  # (q, n_pad)
            approx[:, n_valid:] = -torch.inf
            approx.scatter_(1, scored, -torch.inf)
            _, nid = topk_stable(approx, per)
            approx.scatter_(1, nid, -torch.inf)
            pooled = approx.max(dim=0).values
            pooled[scored.reshape(-1)] = torch.inf
            pooled[nid.reshape(-1)] = torch.inf
            # sorted descending, so every real column (all > -inf) precedes
            # the padded ones, and L < n_valid keeps the pool real
            sl_ids = topk_stable(pooled, shortlist)[1]
            sl_items = items[sl_ids].contiguous()
            loc = torch.full((items.shape[0],), -1, dtype=torch.long, device=ids.device)
            loc[sl_ids] = torch.arange(shortlist, device=ids.device)
        elif sl_ids is None:
            nid = mips_topk_fused(w, items, per, n_valid, exclude=scored)[1]
        else:
            local = mips_topk_fused(w, sl_items, per, shortlist, exclude=loc[scored])[1]
            nid = sl_ids[local]
        ids[:, filled:filled + per] = nid
        vals[:, filled:filled + per] = score_fn(nid)
        filled += per
    return filled


def _topk_state(ids: torch.Tensor, vals: torch.Tensor, top_k: int):
    top_scores, order = topk_stable(vals, min(top_k, vals.shape[1]))
    return top_scores, torch.gather(ids, 1, order)


def stable_topk_flag(
    ids: torch.Tensor, vals: torch.Tensor, per: int, top_k: int, overlap: float = 1.0
) -> torch.Tensor:
    """(q,) bool: is each query's top-``top_k`` id set (nearly) unchanged
    by the last round? ``overlap`` is the required |pre ∩ post| / top_k
    (1.0: set equality); the early-stop convergence signal."""
    k_pre = min(top_k, vals.shape[1] - per)
    if k_pre < top_k:
        return torch.zeros((ids.shape[0],), dtype=torch.bool, device=ids.device)
    _, top_pre = _topk_state(ids[:, :-per], vals[:, :-per], k_pre)
    _, top_post = _topk_state(ids, vals, top_k)
    # a set, not positions: ties may reorder within the top-k
    hit = (top_post[:, :, None] == top_pre[:, None, :]).any(dim=2)
    return hit.float().mean(dim=1) >= overlap


def adaptive_rounds(
    score_fn: ScoreFn,
    completer,  # CurCompleter (train matrix, ridge_rel) | AxnCompleter (item embeddings)
    anchors0: torch.Tensor,  # (first_round,) shared round-0 anchors
    q: int,
    total_budget: int,
    n_rounds: int,
    top_k: int,
    n_valid: int,
    with_state: bool = False,
    stability_overlap: float = 1.0,
    shortlist: Optional[int] = None,
):
    """(top_scores (q, top_k), top_ids (q, top_k), scored_ids (q, budget)),
    plus (vals (q, budget), stable (q,) bool) when ``with_state``: the
    resume state and convergence flag of early-stop escalation. Columns
    ``n_valid`` and above of the item axis are padding. The final ranking
    is the top-k of the exact scores of everything scored."""
    total_budget = min(total_budget, n_valid)
    first, per, n_rounds = split_rounds(total_budget, n_rounds)
    dev = completer.items.device
    ids = torch.empty((q, total_budget), dtype=torch.long, device=dev)
    vals = torch.empty((q, total_budget), dtype=torch.float32, device=dev)
    ids[:, :first] = anchors0[:first].to(dev)[None, :]
    vals[:, :first] = score_fn(ids[:, :first])
    _grow_rounds(score_fn, completer, ids, vals, first, n_rounds - 1, per, n_valid, shortlist)
    top_scores, top_ids = _topk_state(ids, vals, top_k)
    if not with_state:
        return top_scores, top_ids, ids
    if n_rounds > 1:
        stable = stable_topk_flag(ids, vals, per, top_k, stability_overlap)
    else:
        stable = torch.zeros((q,), dtype=torch.bool, device=dev)
    return top_scores, top_ids, ids, vals, stable


def adaptive_continue(
    score_fn: ScoreFn,
    completer,  # as adaptive_rounds'
    ids: torch.Tensor,  # (q, S) resume state from adaptive_rounds(with_state)
    vals: torch.Tensor,  # (q, S)
    extra_budget: int,
    extra_rounds: int,
    top_k: int,
    n_valid: int,
    stability_overlap: float = 1.0,
    shortlist: Optional[int] = None,
):
    """Early-stop escalation: resume queries from their scored state and
    spend ``extra_budget`` more CE calls over ``extra_rounds`` rounds (the
    first takes the remainder, against the full corpus: fresh evidence may
    move candidates far from a base pool). Returns (top_scores, top_ids,
    ids, vals, stable) as adaptive_rounds(with_state=True)."""
    extra_rounds = max(1, min(extra_rounds, extra_budget))
    per = max(1, extra_budget // extra_rounds)
    first = extra_budget - per * (extra_rounds - 1)
    q, s = ids.shape
    ids_b = torch.empty((q, s + extra_budget), dtype=torch.long, device=ids.device)
    vals_b = torch.empty((q, s + extra_budget), dtype=torch.float32, device=ids.device)
    ids_b[:, :s], vals_b[:, :s] = ids, vals
    filled = _grow_rounds(score_fn, completer, ids_b, vals_b, s, 1, first, n_valid)
    _grow_rounds(score_fn, completer, ids_b, vals_b, filled, extra_rounds - 1, per, n_valid, shortlist)
    top_scores, top_ids = _topk_state(ids_b, vals_b, top_k)
    stable = stable_topk_flag(ids_b, vals_b, per, top_k, stability_overlap)
    return top_scores, top_ids, ids_b, vals_b, stable


def _bucket_size(n: int, cap: int) -> int:
    """Next power of two >= n (min 8), capped at ``cap``: the escalation
    batch sizes, as the JAX engine pads them (and counts their cost)."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _oracle_inputs(full_scores, train_scores, device):
    dev = resolve_device(device)
    full = torch.as_tensor(np.asarray(full_scores, np.float32), device=dev)
    train_t = torch.as_tensor(np.asarray(train_scores, np.float32).T.copy(), device=dev)
    return full, train_t


def _oracle_completer(method, train_scores, train_t, ridge_rel, axn_rank, axn_lam_rel):
    """The engine's completer for an oracle run: the CUR ridge over
    ``train_t``, or AXN over a content-cached fit of rank ``axn_rank``
    (default: full) of the train matrix."""
    _check_method(method)
    if method == "cur":
        return CurCompleter(train_t, ridge_rel)
    index = fit_item_embeddings_cached(train_scores, axn_rank or min(np.shape(train_scores)), device=train_t.device)
    return AxnCompleter(index, train_t.shape[0], axn_lam_rel)


def _anchors0(m: int, first: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.asarray(sorted(rng.choice(m, size=first, replace=False)), np.int64))


@torch.no_grad()
def adaptive_topk_oracle(
    full_scores: np.ndarray,  # (q, m) exact scores (the eval oracle)
    train_scores: np.ndarray,  # (n_train, m)
    total_budget: int,
    n_rounds: int = 3,
    top_k: int = 10,
    seed: int = 0,
    ridge_rel: float = 1e-6,
    method: str = "cur",
    shortlist: Optional[int] = None,
    device: DeviceLike = "cuda",
    axn_rank: Optional[int] = None,
    axn_lam_rel: float = 1e-2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The engine against a precomputed score matrix (recall evaluation,
    budget search): (top scores, top ids, scored ids) as numpy.
    ``method='axn'`` completes through rank-``axn_rank`` item embeddings
    fitted from the train matrix (``core/axn.py``)."""
    full, train_t = _oracle_inputs(full_scores, train_scores, device)
    completer = _oracle_completer(method, train_scores, train_t, ridge_rel, axn_rank, axn_lam_rel)
    q, m = full.shape
    budget = min(total_budget, m)
    first, _, _ = split_rounds(budget, n_rounds)
    s, i, scored = adaptive_rounds(
        lambda ids: take_per_row(full, ids), completer, _anchors0(m, first, seed), q, budget,
        n_rounds, top_k, m, shortlist=shortlist,
    )
    return s.cpu().numpy(), i.cpu().numpy(), scored.cpu().numpy()


@torch.no_grad()
def adaptive_topk_oracle_early_stop(
    full_scores: np.ndarray,  # (q, m)
    train_scores: np.ndarray,  # (n_train, m)
    base_budget: int,
    base_rounds: int,
    escalate_budget: int,
    escalate_rounds: int = 3,
    top_k: int = 10,
    seed: int = 0,
    ridge_rel: float = 1e-6,
    method: str = "cur",
    stability_overlap: float = 1.0,
    device: DeviceLike = "cuda",
    axn_rank: Optional[int] = None,
    axn_lam_rel: float = 1e-2,
) -> dict:
    """Per-query early stopping: every query runs the base engine; those
    whose top-k set still changed in the last base round resume from their
    scored state and spend (escalate_budget - base_budget) more CE calls.
    Escalated rows are padded to a power-of-two bucket and the padded rows
    count: avg_budget = base + (padded/q) * extra. Returns {'top_ids',
    'top_scores', 'avg_budget', 'frac_escalated', 'stable_frac'}."""
    full, train_t = _oracle_inputs(full_scores, train_scores, device)
    completer = _oracle_completer(method, train_scores, train_t, ridge_rel, axn_rank, axn_lam_rel)
    q, m = full.shape
    base_budget = min(base_budget, m)
    escalate_budget = min(escalate_budget, m)
    extra = max(0, escalate_budget - base_budget)
    first, _, _ = split_rounds(base_budget, base_rounds)
    s, i, ids, vals, stable = adaptive_rounds(
        lambda x: take_per_row(full, x), completer, _anchors0(m, first, seed), q, base_budget,
        base_rounds, top_k, m, with_state=True, stability_overlap=stability_overlap,
    )
    stable_h = stable.cpu().numpy()
    out_s, out_i = s.cpu().numpy(), i.cpu().numpy()
    unstable = np.flatnonzero(~stable_h)
    n_pad = 0
    if extra > 0 and unstable.size:
        n_pad = _bucket_size(int(unstable.size), q)
        # padded with repeats of the first unstable row: dropped, but counted
        sel = torch.as_tensor(
            np.concatenate([unstable, np.full(n_pad - unstable.size, unstable[0])]), device=full.device
        )
        sub = full[sel]
        s2, i2, _, _, _ = adaptive_continue(
            lambda x: take_per_row(sub, x), completer, ids[sel], vals[sel], extra, escalate_rounds, top_k, m,
        )
        out_s[unstable] = s2.cpu().numpy()[: unstable.size]
        out_i[unstable] = i2.cpu().numpy()[: unstable.size]
    return {
        "top_scores": out_s,
        "top_ids": out_i,
        "avg_budget": base_budget + extra * n_pad / q,
        "frac_escalated": unstable.size / q,
        "stable_frac": float(stable_h.mean()),
    }


def _recall(ids: np.ndarray, full: np.ndarray, top_k: int) -> float:
    exact_top = np.argsort(-full, axis=1)[:, :top_k]
    return float(topk_overlap_frac(torch.as_tensor(np.asarray(ids)), torch.as_tensor(exact_top)).mean())


def adaptive_recall_oracle_early_stop(
    full_scores: np.ndarray,
    train_scores: np.ndarray,
    base_budget: int,
    base_rounds: int,
    escalate_budget: int,
    escalate_rounds: int = 3,
    top_k: int = 10,
    seed: int = 0,
    ridge_rel: float = 1e-6,
    method: str = "cur",
    stability_overlap: float = 1.0,
    device: DeviceLike = "cuda",
    axn_rank: Optional[int] = None,
    axn_lam_rel: float = 1e-2,
) -> Tuple[float, float, float]:
    """(recall@top_k, avg_budget, frac_escalated) of the early-stop engine."""
    full = np.asarray(full_scores, np.float32)
    r = adaptive_topk_oracle_early_stop(
        full, train_scores, base_budget, base_rounds, escalate_budget, escalate_rounds, top_k,
        seed, ridge_rel, method, stability_overlap=stability_overlap, device=device,
        axn_rank=axn_rank, axn_lam_rel=axn_lam_rel,
    )
    return _recall(r["top_ids"], full, top_k), r["avg_budget"], r["frac_escalated"]


@torch.no_grad()
def fixed_anchor_recall(
    full_scores: np.ndarray,
    train_scores: np.ndarray,
    n_anchors: int,
    top_k_retvr: int,
    top_k: int,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> float:
    """recall@top_k of the fixed-anchor CUR path at cost n_anchors +
    top_k_retvr CE calls per query, through the port's ``build_cur``."""
    from anncur_tpu_torch.core.cur import build_cur

    full = np.asarray(full_scores, np.float32)
    train = np.asarray(train_scores, np.float32)
    m = full.shape[1]
    rng = np.random.default_rng(seed)
    anchors = np.asarray(sorted(rng.choice(m, size=min(n_anchors, m), replace=False)))
    index = build_cur(
        rows=train, cols=train[:, anchors], row_idxs=np.arange(train.shape[0]), col_idxs=anchors,
        approx_preference="rows", validate=False, device=device,
    )
    sparse = torch.as_tensor(full[:, anchors], device=index.latent_cols.device)
    approx = index.get_complete_row(sparse).cpu().numpy()
    cand = np.argsort(-approx, axis=1)[:, :top_k_retvr]
    vals = np.take_along_axis(full, cand, axis=1)
    reranked = np.take_along_axis(cand, np.argsort(-vals, axis=1)[:, :top_k], axis=1)
    return _recall(reranked, full, top_k)


def adaptive_recall_oracle(
    full_scores: np.ndarray,
    train_scores: np.ndarray,
    total_budget: int,
    n_rounds: int = 3,
    top_k: int = 10,
    seed: int = 0,
    ridge_rel: float = 1e-6,
    method: str = "cur",
    shortlist: Optional[int] = None,
    device: DeviceLike = "cuda",
    axn_rank: Optional[int] = None,
    axn_lam_rel: float = 1e-2,
) -> float:
    """recall@top_k of the adaptive engine at the given budget."""
    full = np.asarray(full_scores, np.float32)
    _, ids, _ = adaptive_topk_oracle(
        full, train_scores, total_budget, n_rounds, top_k, seed, ridge_rel, method=method,
        shortlist=shortlist, device=device, axn_rank=axn_rank, axn_lam_rel=axn_lam_rel,
    )
    return _recall(ids, full, top_k)


def matched_recall_budget(
    full_scores: np.ndarray,
    train_scores: np.ndarray,
    fixed_n_anchors: int = 500,
    fixed_top_k_retvr: int = 100,
    top_k: int = 10,
    n_rounds: int = 3,
    seeds: Sequence[int] = (0, 1, 2),
    budgets: Sequence[int] = (40, 60, 80, 120, 160, 240, 320, 480, 600),
    ridge_rel: float = 1e-6,
    method: str = "cur",
    device: DeviceLike = "cuda",
    axn_rank: Optional[int] = None,
) -> dict:
    """The smallest adaptive budget whose mean recall@top_k matches (>=)
    the fixed-anchor path at cost fixed_n_anchors + fixed_top_k_retvr,
    with the whole sweep."""
    fixed = float(np.mean([
        fixed_anchor_recall(full_scores, train_scores, fixed_n_anchors, fixed_top_k_retvr, top_k, s, device)
        for s in seeds
    ]))
    sweep, matched = {}, None
    for b in sorted(budgets):
        r = float(np.mean([
            adaptive_recall_oracle(full_scores, train_scores, b, n_rounds, top_k, s, ridge_rel,
                                   method=method, device=device, axn_rank=axn_rank)
            for s in seeds
        ]))
        sweep[b] = r
        if matched is None and r >= fixed:
            matched = b
    return {
        "fixed_cost": fixed_n_anchors + fixed_top_k_retvr,
        "fixed_recall": fixed,
        "adaptive_sweep": sweep,
        "matched_budget": matched,
        "top_k": top_k,
        "n_rounds": n_rounds,
        "seeds": list(seeds),
        "method": method,
        "axn_rank": axn_rank,
    }
