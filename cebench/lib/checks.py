"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference recomputed from the run's own inputs.

Every number is a widest gap in the scores' own units (or, for a ranking
stage, as a share of the row's largest score), compared with the limit in
the cell's traffic file. The same functions judge the control, the
reference computed one precision lower and put in the program's place.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from cebench.lib import reference


def topk_answer_gap(truth: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor) -> float:
    """How far one row's top-k answer (ids, with the scores returned for
    them) lies from the f64 ``truth`` over every item (-inf where an item
    may not be picked), as a share of the row's largest |truth|: the larger
    of the ranking's shortfall (:func:`reference.rank_gap`) and the widest
    score error."""
    ids = ids.to(truth.device).long()
    top = float(truth[torch.isfinite(truth)].abs().max())
    rank = reference.rank_gap(truth[None], ids[None], len(ids))
    err = float((scores.to(truth.device).double() - truth[ids]).abs().max())
    return max(rank, err) / top


class FixedAnswer(NamedTuple):
    """One fixed-anchor query as the path answered it: its anchor scores
    (k_i,) as kernel B got them, the candidates (k_retvr,) kernel B
    returned, and the top-k (scores, item ids) returned to the caller."""

    query: int
    anchor_scores: torch.Tensor
    candidates: torch.Tensor
    cand_scores: torch.Tensor
    scores: np.ndarray
    ids: np.ndarray


def fixed_gaps(tree, cfg, pair_len: int, queries: torch.Tensor, items: torch.Tensor, latent: np.ndarray,
               anchors: np.ndarray, answers: List[FixedAnswer], anchor_sample: np.ndarray) -> Dict[str, float]:
    """The fixed-anchor path, stage by stage:

    - ``anchor_gap``: the anchor CE scores kernel B got vs the reference's
      (at ``anchor_sample``'s anchor positions of each answer);
    - ``cand_gap``: kernel B's answer against the reference's completion of
      those same anchor scores (f64, U R recomputed from R), as a share of
      the row's largest completed score: the larger of how far its
      candidates fall short of the completion's own top k_retvr and how far
      the scores it returned with them lie from the completion's;
    - ``rerank_gap``: each returned score vs the reference's CE score of
      that (query, item);
    - ``order_gap``: the returned items ranked by the reference's CE scores
      of every candidate, short of the reference's own top k among them.
    A returned id outside the candidates makes ``order_gap`` infinite."""
    dev = items.device
    latent_t = torch.as_tensor(latent, dtype=torch.float64, device=dev)
    anchor_gap = cand_gap = rerank_gap = order_gap = 0.0
    for ans in answers:
        q_tok = queries[ans.query][None]
        pos = torch.as_tensor(anchor_sample, device=dev)
        a_ids = torch.as_tensor(anchors, device=dev)[pos]
        ref_a = reference.ce_scores(tree, cfg, q_tok.expand(len(pos), -1), items[a_ids], pair_len)
        anchor_gap = max(anchor_gap, float((ans.anchor_scores.to(dev)[pos] - ref_a).abs().max()))

        approx = ans.anchor_scores.to(dev).double()[None] @ latent_t  # (1, n)
        cand_gap = max(cand_gap, topk_answer_gap(approx[0], ans.candidates, ans.cand_scores))

        cands = ans.candidates.to(dev).long()
        exact = reference.ce_scores(tree, cfg, q_tok.expand(len(cands), -1), items[cands], pair_len)
        cand_list = ans.candidates.cpu().numpy().tolist()
        where = {int(c): j for j, c in enumerate(cand_list)}
        if any(int(i) not in where for i in ans.ids):
            order_gap = float("inf")
            continue
        pos_ret = torch.as_tensor([where[int(i)] for i in ans.ids], device=dev)
        rerank_gap = max(rerank_gap, float((torch.as_tensor(ans.scores, device=dev) - exact[pos_ret]).abs().max()))
        order_gap = max(order_gap, reference.rank_gap(exact[None], pos_ret[None], len(pos_ret)))
    return {"anchor_gap": anchor_gap, "cand_gap": cand_gap, "rerank_gap": rerank_gap, "order_gap": order_gap}


def reference_fixed(tree, cfg, pair_len: int, queries: torch.Tensor, items: torch.Tensor, latent_f32: torch.Tensor,
                    anchors: np.ndarray, query_ids: List[int], k_retvr: int, top_k: int,
                    precision: str, mips_precision: str) -> List[FixedAnswer]:
    """The fixed-anchor path computed by the reference at ``precision``
    (CE) and ``mips_precision`` (the completion's product), in the
    program's place: the control's answers."""
    dev = items.device
    a_ids = torch.as_tensor(anchors, device=dev)
    out = []
    for qi in query_ids:
        q_tok = queries[qi][None]
        a = reference.ce_scores(tree, cfg, q_tok.expand(len(a_ids), -1), items[a_ids], pair_len, precision)
        approx = reference.mips_scores(a[None], latent_f32, mips_precision)  # latent held (n, k_i)
        c_scores, cands = reference.topk(approx, k_retvr)
        exact = reference.ce_scores(tree, cfg, q_tok.expand(k_retvr, -1), items[cands[0]], pair_len, precision)
        s, order = reference.topk(exact[None], top_k)
        out.append(FixedAnswer(qi, a, cands[0], c_scores[0], s[0].cpu().numpy(), cands[0][order[0]].cpu().numpy()))
    return out


class AdaptiveAnswer(NamedTuple):
    """One adaptive query as the engine answered it: for each growth round,
    the scored ids and their exact scores the completer got, the weights it
    handed kernel B, and the ids kernel B picked with its scores of them;
    then the top-k (scores, item ids) returned."""

    query: int
    rounds: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]
    scores: np.ndarray
    ids: np.ndarray


def ridge_completion(train_t: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor, ridge_rel: float) -> torch.Tensor:
    """(n,) f64 ridge completion of one query's scores over every item:
    c = the train matrix's columns at its scored ids (rows of ``train_t``,
    (n, n_train)), w = cᵀ (c cᵀ + λI)⁻¹ vals with λ = ridge_rel · trace / S,
    completion = w · each item's train column (the engine's stated
    completion, ``core/adaptive_fused.py``)."""
    c = train_t[ids.long()].double()
    gram = c @ c.T
    lam = ridge_rel * gram.diagonal().sum() / c.shape[0]
    z = torch.linalg.solve(gram + lam * torch.eye(c.shape[0], dtype=gram.dtype, device=gram.device), vals.double())
    return train_t.double() @ (c.T @ z)


def adaptive_gaps(tree, cfg, pair_len: int, queries: torch.Tensor, items: torch.Tensor, train_t: torch.Tensor,
                  ridge_rel: float, budget: int, answers: List[AdaptiveAnswer]) -> Dict[str, float]:
    """The adaptive engine, stage by stage, from its own state:

    - ``budget_short``: the budget less the distinct valid ids a query
      scored (0 when it scored exactly its budget);
    - ``vals_gap``: the exact scores the completer got vs the reference's
      CE scores of those (query, item) pairs;
    - ``ridge_gap``: the completion the weights give (f64 product with the
      train matrix) vs the reference's f64 ridge completion of that round's
      scored ids and scores, as a share of the row's largest;
    - ``pick_gap``: each round's kernel B answer (picks and their scores)
      against the f64 product of the weights it got, over unscored items
      (:func:`topk_answer_gap`);
    - ``score_gap``: each returned score vs the reference's CE score;
    - ``order_gap``: the returned items ranked by the reference's CE scores
      of everything the query scored, short of its own top k."""
    dev = items.device
    n_items = items.shape[0]
    out = {"budget_short": 0.0, "vals_gap": 0.0, "ridge_gap": 0.0, "pick_gap": 0.0, "score_gap": 0.0,
           "order_gap": 0.0}
    for ans in answers:
        last_ids, _, _, last_picks, _ = ans.rounds[-1]
        scored = torch.cat([last_ids.to(dev), last_picks.to(dev)]).long()
        valid = scored[(scored >= 0) & (scored < n_items)]
        out["budget_short"] = max(out["budget_short"], float(budget - torch.unique(valid).numel()))
        if valid.numel() != scored.numel():
            out["order_gap"] = float("inf")
            continue
        q_tok = queries[ans.query][None]
        exact = reference.ce_scores(tree, cfg, q_tok.expand(len(scored), -1), items[scored], pair_len)
        ref_of = dict(zip(scored.tolist(), exact.tolist()))
        for ids, vals, weights, picks, pick_scores in ans.rounds:
            ids = ids.to(dev).long()
            ref_vals = torch.as_tensor([ref_of.get(int(i), float("nan")) for i in ids], device=dev)
            out["vals_gap"] = max(out["vals_gap"], float((vals.to(dev) - ref_vals).abs().max()))
            ridge = ridge_completion(train_t, ids, vals.to(dev), ridge_rel)
            given = train_t.double() @ weights.to(dev).double()
            gap = float((given - ridge).abs().max() / ridge.abs().max())
            out["ridge_gap"] = max(out["ridge_gap"], gap)
            given[ids] = -torch.inf
            out["pick_gap"] = max(out["pick_gap"], topk_answer_gap(given, picks, pick_scores))
        if any(int(i) not in ref_of for i in ans.ids):
            out["order_gap"] = float("inf")
            continue
        ret = torch.as_tensor([ref_of[int(i)] for i in ans.ids], device=dev)
        out["score_gap"] = max(out["score_gap"], float((torch.as_tensor(ans.scores, device=dev) - ret).abs().max()))
        pos = {int(i): j for j, i in enumerate(scored.tolist())}
        chosen = torch.as_tensor([pos[int(i)] for i in ans.ids], device=dev)
        out["order_gap"] = max(out["order_gap"], reference.rank_gap(exact[None], chosen[None], len(chosen)))
    return out


def reference_adaptive(tree, cfg, pair_len: int, queries: torch.Tensor, items: torch.Tensor, train_t: torch.Tensor,
                       anchors0: np.ndarray, query_ids: List[int], budget: int, n_rounds: int, top_k: int,
                       ridge_rel: float, precision: str, mips_precision: str) -> List[AdaptiveAnswer]:
    """The adaptive engine computed by the reference at ``precision`` (CE)
    and ``mips_precision`` (the ridge's products and the completion's), in
    the program's place: round 0 scores the shared anchors, each later
    round completes (ridge) and picks its best unscored items. The
    control's answers."""
    dev = items.device
    n_rounds = max(1, min(n_rounds, budget))
    per = max(1, budget // n_rounds)
    first = budget - per * (n_rounds - 1)
    train32 = train_t.float()
    out = []
    for qi in query_ids:
        q_tok = queries[qi][None]
        ids = torch.as_tensor(anchors0[:first], device=dev).long()
        vals = reference.ce_scores(tree, cfg, q_tok.expand(first, -1), items[ids], pair_len, precision)
        rounds = []
        for _ in range(n_rounds - 1):
            c = train32[ids]
            gram = reference.mips_scores(c, c, mips_precision)
            lam = ridge_rel * gram.diagonal().sum() / c.shape[0]
            with reference.true_f32():
                z = torch.linalg.solve(gram + lam * torch.eye(c.shape[0], device=dev), vals)
            w = reference.mips_scores(z[None], c.T.contiguous(), mips_precision)
            approx = reference.mips_scores(w, train32, mips_precision)
            p_scores, picks = reference.topk(approx, per, exclude=ids[None])
            rounds.append((ids.clone(), vals.clone(), w[0], picks[0], p_scores[0]))
            new = reference.ce_scores(tree, cfg, q_tok.expand(per, -1), items[picks[0]], pair_len, precision)
            ids, vals = torch.cat([ids, picks[0]]), torch.cat([vals, new])
        s, order = reference.topk(vals[None], top_k)
        out.append(AdaptiveAnswer(qi, rounds, s[0].cpu().numpy(), ids[order[0]].cpu().numpy()))
    return out
