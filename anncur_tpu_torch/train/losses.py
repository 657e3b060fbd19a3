"""Training losses, in PyTorch.

Counterpart of ``anncur_tpu/train/losses.py``, exact semantic parity with
the reference. Bi-encoder (models/biencoder.py:551-638): ce / hinge /
hinge_sq with explicit negatives, in-batch negatives, and soft-target
distillation (:513-549). Cross-encoder (models/crossencoder.py:517-606):
ce / bce over (pos, negs) score rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn import functional as F

from anncur_tpu_torch.parallel.mesh import all_gather_grad
from anncur_tpu_torch.utils.device import true_f32


def _softmax_xent_int_target(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """F.cross_entropy with integer targets, mean reduction."""
    logp = F.log_softmax(scores, dim=-1)
    return -logp.gather(1, target[:, None])[:, 0].mean()


def scores_loss_w_negs(
    pos_scores: torch.Tensor,  # (b,)
    neg_scores: torch.Tensor,  # (b, n)
    loss_type: str = "ce",
    hinge_margin: float = 0.5,
) -> torch.Tensor:
    """Loss over explicit (pos, negs) scores
    (reference: compute_loss_w_negs, models/biencoder.py:570-599)."""
    if loss_type == "ce":
        final = torch.cat([pos_scores[:, None], neg_scores], dim=1)
        return _softmax_xent_int_target(final, torch.zeros(final.shape[0], dtype=torch.long, device=final.device))
    if loss_type in ("hinge", "hinge_sq"):
        # ignore positives above margin / negatives below -margin (:582-585)
        pos = torch.where(pos_scores > hinge_margin, torch.zeros_like(pos_scores), pos_scores)[:, None]
        neg = torch.where(neg_scores < -hinge_margin, torch.zeros_like(neg_scores), neg_scores)
        if loss_type == "hinge":
            return (-pos.mean() + neg.mean()) / 2
        return (((hinge_margin - pos) ** 2).mean() + ((hinge_margin + neg) ** 2).mean()) / 2
    raise NotImplementedError(f"loss_type={loss_type!r}")


def bienc_loss_w_negs(
    input_embs: torch.Tensor,  # (b, d)
    pos_label_embs: torch.Tensor,  # (b, d)
    neg_label_embs: torch.Tensor,  # (b, n, d)
    loss_type: str = "ce",
    hinge_margin: float = 0.5,
) -> torch.Tensor:
    pos_scores = (input_embs * pos_label_embs).sum(1)
    neg_scores = (neg_label_embs * input_embs[:, None, :]).sum(2)
    return scores_loss_w_negs(pos_scores, neg_scores, loss_type, hinge_margin)


def bienc_loss_in_batch_negs(
    input_embs: torch.Tensor,  # (b, d)
    pos_label_embs: torch.Tensor,  # (b, d)
    loss_type: str = "ce",
    hinge_margin: float = 0.5,
    group=None,
) -> torch.Tensor:
    """In-batch negatives (reference: compute_loss_w_in_batch_negs,
    models/biencoder.py:604-638). The (b, b) score matmul runs in true f32
    (``utils/device.py::true_f32``), whatever the caller set.

    ``group``: a data-parallel process group. Each rank passes its equal
    share of the rows of one global batch; every row is scored against the
    positives of every rank (gathered with their gradients flowing back to
    their rank), and the rank returns its rows' mean. The mean of these
    over the ranks is the one-process loss of the global batch, and so is
    the mean of their gradients."""
    pos = pos_label_embs
    offset = 0
    if group is not None:
        pos = all_gather_grad(pos_label_embs, group)
        offset = dist.get_rank(group) * input_embs.shape[0]
    with true_f32():
        scores = input_embs.float() @ pos.float().T
    b, n = scores.shape
    rows = torch.arange(b, device=scores.device)
    if loss_type == "ce":
        return _softmax_xent_int_target(scores, rows + offset)
    if loss_type in ("hinge", "hinge_sq"):
        y = -torch.ones((b, n), device=scores.device)
        y[rows, rows + offset] = 1.0
        loss = torch.clamp(hinge_margin - y * scores, min=0.0)
        return loss.mean() if loss_type == "hinge" else (loss * loss).mean()
    raise NotImplementedError(f"loss_type={loss_type!r}")


def distill_loss(
    pred_label_scores: torch.Tensor,  # (b, L) student scores
    target_label_scores: torch.Tensor,  # (b, L) teacher (CE) scores
) -> torch.Tensor:
    """Soft cross-entropy against softmaxed teacher scores
    (reference: forward_w_ment_ent_distill, models/biencoder.py:542-547)."""
    target = torch.softmax(target_label_scores, dim=-1)
    logp = F.log_softmax(pred_label_scores, dim=-1)
    return -(target * logp).sum(-1).mean()


def crossenc_loss(
    pos_scores: torch.Tensor,  # (b,)
    neg_scores: torch.Tensor,  # (b, n)
    loss_type: str = "ce",
) -> torch.Tensor:
    """Cross-encoder ce / bce (reference: crossencoder.py:517-606)."""
    if loss_type == "ce":
        final = torch.cat([pos_scores[:, None], neg_scores], dim=1)
        return _softmax_xent_int_target(final, torch.zeros(final.shape[0], dtype=torch.long, device=final.device))
    if loss_type == "bce":
        pos_loss = _bce_with_logits(pos_scores, torch.ones_like(pos_scores)).mean()
        neg_loss = _bce_with_logits(neg_scores, torch.zeros_like(neg_scores)).mean()
        return (pos_loss + neg_loss) / 2
    raise NotImplementedError(f"loss_type={loss_type!r}")


def _bce_with_logits(logits, targets):
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def mrr_from_scores(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    """Batch MRR of the positive among (pos, negs)
    (reference: compute_eval_metrics, crossencoder.py:541-566)."""
    rank = 1.0 + (neg_scores > pos_scores[:, None]).sum(1).float()
    return (1.0 / rank).mean()
