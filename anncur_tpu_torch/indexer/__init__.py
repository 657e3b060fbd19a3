"""Score-matrix builds, chunk combiners, splits and entity-to-entity
scores (counterpart of ``anncur_tpu/indexer``)."""

from anncur_tpu_torch.indexer.score_matrix import (  # noqa: F401
    ScoreMatrixBuilder,
    build_pairs,
    save_score_matrix,
    load_score_matrix,
)
from anncur_tpu_torch.indexer.combine import combine_chunks  # noqa: F401
