"""Matrix-rank probes for score matrices.

Counterpart of ``anncur_tpu/evalx/rank_probe.py`` (parity with
eval/compute_m2e_matrix_ranks.py:29-114): the effective numerical rank of
cross-encoder score matrices (the empirical motivation for CUR: CE
matrices are approximately low-rank), and the bi-encoder's full score
matrix (by construction of rank <= embed_dim).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from anncur_tpu_torch.evalx.core import on_device, to_host
from anncur_tpu_torch.utils.device import DeviceLike, true_f32

LOGGER = logging.getLogger(__name__)


def matrix_rank_report(matrix: np.ndarray, rcond: Optional[float] = None) -> Dict:
    """Numerical rank and a singular-value spectrum summary (host SVD)."""
    mat = np.asarray(matrix, np.float32)
    sv = np.linalg.svd(mat, compute_uv=False)
    if rcond is None:
        rcond = max(mat.shape) * np.finfo(np.float32).eps
    cutoff = rcond * sv[0] if len(sv) else 0.0
    rank = int(np.sum(sv > cutoff))
    energy = np.cumsum(sv**2) / max(np.sum(sv**2), 1e-30)
    return {
        "shape": list(mat.shape),
        "rank": rank,
        "rank_99pct_energy": int(np.searchsorted(energy, 0.99) + 1),
        "rank_999pct_energy": int(np.searchsorted(energy, 0.999) + 1),
        "top_singular_values": sv[:10].tolist(),
        "rcond": float(rcond),
    }


def bienc_score_matrix(input_embeds, label_embeds, device: DeviceLike = "cuda") -> np.ndarray:
    """Full dense bi-encoder score matrix, a true-f32 product on ``device``
    (reference: compute_binec_ment_to_ent_scores,
    compute_m2e_matrix_ranks.py:58-114)."""
    inp = on_device(input_embeds, device)
    lab = on_device(label_embeds, inp.device)
    with true_f32():
        return to_host(torch.matmul(inp, lab.T))
