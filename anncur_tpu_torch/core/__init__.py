"""CUR index, retriever, adaptive engines, AXN and metrics (counterpart of
``anncur_tpu/core``)."""

from anncur_tpu_torch.core.cur import CurIndex, build_cur  # noqa: F401
from anncur_tpu_torch.core.metrics import (  # noqa: F401
    frobenius_error,
    overlap_metrics,
    reciprocal_ranks,
    score_topk_preds,
    topk_overlap_frac,
)
