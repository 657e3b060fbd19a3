"""Int8 item embeddings with per-row scales, and MIPS over them.

Counterpart of ``anncur_tpu/ops/quantized.py``: items are stored as int8
with one f32 scale per row, queries stay f32, and a score is the f32 dot
product of the query with the int8 values, multiplied by the row's scale
after the sum. The point is the retrieval scan's bytes: 1 byte per item
entry in place of 4. :func:`mips_topk_int8` is kernel B's int8 entry
(``ops/mips_kernel.py::mips_topk_int8_fused``), which streams the int8
rows as they are; its plain version ``mips_topk_int8_plain`` lives with
kernel B's other one in ``ops/mips.py`` and is re-exported here.
"""

from __future__ import annotations

import dataclasses

import torch

from anncur_tpu_torch.ops.mips import mips_topk_int8_plain  # noqa: F401 (re-exported)
from anncur_tpu_torch.ops.mips_kernel import mips_topk_int8_fused


@dataclasses.dataclass(frozen=True)
class QuantizedItems:
    values: torch.Tensor  # (n, d) int8
    scales: torch.Tensor  # (n, 1) f32: row abs-max / 127, 1 for a zero row

    @property
    def shape(self):
        return self.values.shape


def quantize_items(items) -> QuantizedItems:
    """Per-row symmetric int8 quantisation, bit-equal to JAX's: scale =
    abs-max / 127 (1 for a zero row), values = round-half-to-even(x /
    scale) clipped to [-127, 127]. Takes a tensor (kept on its device) or
    an array."""
    items = torch.as_tensor(items).float()
    abs_max = items.abs().amax(dim=1, keepdim=True)
    scale = torch.where(abs_max == 0, torch.ones_like(abs_max), abs_max / 127.0)
    values = torch.clamp(torch.round(items / scale), -127, 127).to(torch.int8)
    return QuantizedItems(values=values, scales=scale)


# (queries (q, d) f32, items, k, n_valid=None, exclude=None) -> (scores (q, k)
# f32, ids (q, k) int64): exact top-k over ``dot_f32(q, float(v)) * scale``
# (JAX's ``mips_topk_int8``, whose ``chunk`` only shaped its scan). CPU tensors
# take the plain version; CUDA tensors launch kernel B's int8 entry or raise.
mips_topk_int8 = mips_topk_int8_fused
