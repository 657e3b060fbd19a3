"""The hand-written kernels' wrappers, their plain versions, MIPS, the
dense index and pinv (counterpart of ``anncur_tpu/ops``). No kernel is
built or loaded at import: ``ops/cuda_build.py`` loads each library at its
first call."""

from anncur_tpu_torch.ops.pinv import pinv, pinv_f64  # noqa: F401
from anncur_tpu_torch.ops.mips import (  # noqa: F401
    mips_topk,
    mips_topk_sharded,
    masked_topk,
)
