"""Dense MIPS index: exact inner-product search over item embeddings.

Counterpart of ``anncur_tpu/ops/dense_index.py`` (the reference's FAISS
wrapper, models/nearest_nbr.py:24-80). Always exact: every search is one
call of kernel B on the card (``ops/mips_kernel.py``), over f32 rows or,
with ``quantize=True``, over int8 rows with per-row scales
(``ops/quantized.py``), which cuts the scan's item bytes 4x. The JAX
package's size dispatch between a materialised score matrix and a
streaming scan has no counterpart: kernel B scores queries in chunks that
fit its scratch whatever the corpus.

With ``mesh=`` the f32 rows are padded to the ``data`` axis
(``pad_items``) and each rank keeps its shard on its device; a search is
``ops/mips.py::topk_of_shards`` (kernel B per shard, candidates
all-gathered), and every rank calls it in lockstep with the same queries.
An int8 index searches on each rank's own device over the whole corpus
(JAX's quantised search is single-device too).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from anncur_tpu_torch.ops.mips import pad_items, topk_of_shards
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused, mips_topk_int8_fused
from anncur_tpu_torch.ops.quantized import quantize_items
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device, same_device
from anncur_tpu_torch.utils.tracker import TRACER

LOGGER = logging.getLogger(__name__)


class DenseIndex:
    """Exact inner-product search over item embeddings (FAISS ``.add`` /
    ``.search`` parity). The index keeps one copy of the corpus on
    ``device``: the f32 rows (this rank's shard over a mesh), or int8 rows
    and their scales; a host f32 copy feeds :meth:`add`."""

    def __init__(self, embeds, mesh=None, quantize: bool = False, device: DeviceLike = "cuda"):
        """``quantize=True`` stores items as int8 with per-item scales: ~4x
        less traffic on the scan at <0.5% score error; pair with exact
        reranking. ``mesh``: shard the f32 rows over its ``data`` axis."""
        self.device = resolve_device(device)
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's rank lives on {mesh.device}, the index on {self.device}")
        self.mesh = mesh
        self._quantize = bool(quantize)
        if quantize and mesh is not None and mesh.size > 1:
            LOGGER.warning(
                "quantize=True: int8 search runs single-device; the %d-rank mesh is ignored for search", mesh.size
            )
        self._host_embeds = _host_f32(embeds)
        self._rebuild_device_state()

    def _rebuild_device_state(self) -> None:
        self.n, self.dim = self._host_embeds.shape
        rows = torch.as_tensor(self._host_embeds, device=self.device)
        self.embeds = self.quantized = None
        self._base = 0
        if self._quantize:
            self.quantized = quantize_items(rows)
        elif self.mesh is not None:
            n_dev = self.mesh.shape["data"]
            padded, _ = pad_items(rows, n_dev)
            shard = padded.shape[0] // n_dev
            self._base = self.mesh.coords["data"] * shard
            self.embeds = padded[self._base: self._base + shard].contiguous()
        else:
            self.embeds = rows

    def add(self, embeds) -> None:
        """Append items. Rebuilds the device copy and, for a quantised
        index, re-quantises, so searches see the new items."""
        self._host_embeds = np.concatenate([self._host_embeds, _host_f32(embeds)])
        self._rebuild_device_state()

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (q, k) f32, ids (q, k) int64) as numpy: the exact top-k by
        inner product, k = min(k, n), ties to the lowest id. Traced as an
        ``index.search`` span holding ``index.to_host`` (the copy out)."""
        with TRACER.span("index.search"):
            queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device).contiguous()
            k = min(k, self.n)
            if self.quantized is not None:
                s, i = mips_topk_int8_fused(queries, self.quantized, k)
            elif self.mesh is not None:
                s, i = topk_of_shards(queries, self.embeds, k, self.mesh, "data", self._base, self.n)
            else:
                s, i = mips_topk_fused(queries, self.embeds, k)
            with TRACER.span("index.to_host"):
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
