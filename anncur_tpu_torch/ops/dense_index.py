"""Dense MIPS index: exact inner-product search over item embeddings.

Counterpart of ``anncur_tpu/ops/dense_index.py`` (the reference's FAISS
wrapper, models/nearest_nbr.py:24-80). Always exact: every search is one
call of kernel B on the card (``ops/mips_kernel.py``), over f32 rows or,
with ``quantize=True``, over int8 rows with per-row scales
(``ops/quantized.py``), which cuts the scan's item bytes 4x. The JAX
package's size dispatch between a materialised score matrix and a
streaming scan has no counterpart: kernel B scores queries in chunks that
fit its scratch whatever the corpus.

Multi-device search (the JAX package's mesh) is not ported: ``mesh=``
raises (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused, mips_topk_int8_fused
from anncur_tpu_torch.ops.quantized import quantize_items
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device

LOGGER = logging.getLogger(__name__)


def reject_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded search is not ported: ROADMAP.md Queue 1 item 9 (one device only)"
        )


class DenseIndex:
    """Exact inner-product search over item embeddings (FAISS ``.add`` /
    ``.search`` parity). The index keeps one copy of the corpus on
    ``device``: the f32 rows, or int8 rows and their scales; a host f32
    copy feeds :meth:`add`."""

    def __init__(self, embeds, mesh=None, quantize: bool = False, device: DeviceLike = "cuda"):
        """``quantize=True`` stores items as int8 with per-item scales: ~4x
        less traffic on the scan at <0.5% score error; pair with exact
        reranking."""
        reject_mesh(mesh)
        self.device = resolve_device(device)
        self._quantize = bool(quantize)
        self._host_embeds = _host_f32(embeds)
        self._rebuild_device_state()

    def _rebuild_device_state(self) -> None:
        self.n, self.dim = self._host_embeds.shape
        rows = torch.as_tensor(self._host_embeds, device=self.device)
        self.embeds = self.quantized = None
        if self._quantize:
            self.quantized = quantize_items(rows)
        else:
            self.embeds = rows

    def add(self, embeds) -> None:
        """Append items. Rebuilds the device copy and, for a quantised
        index, re-quantises, so searches see the new items."""
        self._host_embeds = np.concatenate([self._host_embeds, _host_f32(embeds)])
        self._rebuild_device_state()

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (q, k) f32, ids (q, k) int64) as numpy: the exact top-k by
        inner product, k = min(k, n), ties to the lowest id."""
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device).contiguous()
        k = min(k, self.n)
        if self.quantized is not None:
            s, i = mips_topk_int8_fused(queries, self.quantized, k)
        else:
            s, i = mips_topk_fused(queries, self.embeds, k)
        return s.cpu().numpy(), i.cpu().numpy()


def _host_f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.ascontiguousarray(np.asarray(x, np.float32))


def build_flat_or_ivff_index(
    embeds,
    force_exact_search: bool = False,
    approx_search_mult: int = 0,
    mesh=None,
    device: DeviceLike = "cuda",
) -> DenseIndex:
    """Name and signature of the reference's builder
    (models/nearest_nbr.py:24-55); always exact (see the module doc)."""
    if not force_exact_search and embeds.shape[0] > 11000:
        LOGGER.info("reference would build IVF here (n=%d); exact search used instead", embeds.shape[0])
    return DenseIndex(embeds, mesh=mesh, device=device)
