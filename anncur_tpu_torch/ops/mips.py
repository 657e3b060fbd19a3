"""Exact maximum-inner-product search (MIPS), plain PyTorch.

Counterpart of ``anncur_tpu/ops/mips.py``. The top-k is a STABLE
descending sort: ``torch.topk`` does not promise the lowest-index
tie-break that ``lax.top_k`` gives, and the port keeps that order. This
module is also the plain version of kernel B (``ops/mips_kernel.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# "Excluded" score fill, as anncur_tpu/ops/mips.py::NEG_INF: never selected
# by a top-k over real scores, and representable in float32.
NEG_INF = -1e30


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest entries along the last
    axis, descending, ties to the lowest index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_topk(
    scores: torch.Tensor,  # (q, n)
    k: int,
    valid: Optional[torch.Tensor] = None,  # (n,) or (q, n) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k over scores with invalid positions excluded."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device))
    return topk_stable(scores, k)


def mips_topk(
    queries: torch.Tensor,  # (q, d) f32
    items: torch.Tensor,  # (n, d) f32
    k: int,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS: scores = Q @ Iᵀ in f32, top-k per query over the first
    ``n_valid`` items (default: all)."""
    n = items.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if not 1 <= k <= n_valid <= n:
        raise ValueError(f"mips_topk needs 1 <= k <= n_valid <= n, got k={k} n_valid={n_valid} n={n}")
    scores = queries.float() @ items.float().T
    valid = None
    if n_valid < n:
        valid = torch.arange(n, device=scores.device) < n_valid
    return masked_topk(scores, k, valid)
