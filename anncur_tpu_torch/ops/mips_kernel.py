"""Exact MIPS top-k: kernel B (``csrc/mips_topk.cu``).

Replaces ``anncur_tpu/ops/mips_pallas.py::_mips_kernel`` and
``::_maxmask_kernel``. The fixed-anchor query runs its latent projection
+ top-k_retvr stage through :func:`mips_topk_fused`, the adaptive engine
every candidate pick (the query's scored ids excluded), the dense index
every search and the hard-negative miner every mine. Its plain version
is ``ops/mips.py::mips_topk``. :func:`mips_topk_int8_fused` is the same
kernel over int8 items with per-row scales (``ops/quantized.py``); its
plain version is ``ops/mips.py::mips_topk_int8_plain``.

On the card it is a score GEMM into a score scratch, then an exact radix
select, one thread-block cluster per query; any ``1 <= k <= n_valid - S``,
as ``lax.top_k`` takes. The score GEMM of f32 items runs on the tensor
cores in three TF32 passes (f32-accurate, as the reference's
``precision="highest"`` is on the TPU) for chunks of more than 32 queries
over rows of 16 bytes (d % 4 == 0, aligned bases), and as an IEEE FFMA
chain otherwise; int8 items take the FFMA chain.

Both entries place themselves by ``cuda_build.on_cpu``: CPU tensors take
the plain versions, others kernel B, which raises on what it cannot take.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, Optional, Set, Tuple

import torch

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops.cuda_build import I32, I64, PTR, STREAM
from anncur_tpu_torch.ops.mips import check_exclude, mips_topk, mips_topk_int8_plain

if TYPE_CHECKING:  # ops/quantized.py imports this module
    from anncur_tpu_torch.ops.quantized import QuantizedItems

# score scratch by (device index, stream): one allocation, grown as needed
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_INIT_DEVICES: Set[int] = set()

# after the item pointers: outputs, exclusions, scratch, sizes, the count of
# chunks scored on the tensor cores
_AFTER_ITEMS = [PTR, PTR, PTR, I32, I64, PTR, I64] + [I32] * 5 + [ctypes.POINTER(I32)]
_FUSED = cuda_build.Entry("mips_topk", "mips_topk_fused", [PTR] * 2 + _AFTER_ITEMS, STREAM)
_INT8 = cuda_build.Entry("mips_topk", "mips_topk_int8_fused", [PTR] * 3 + _AFTER_ITEMS, STREAM)
_SCRATCH_BYTES = cuda_build.Entry("mips_topk", "mips_topk_scratch_bytes", [I32] * 3, (), I64)
_INIT = cuda_build.Entry("mips_topk", "mips_topk_init", [], ())


def mips_topk_fused(
    queries: torch.Tensor,  # (q, d) f32
    items: torch.Tensor,  # (n, d) f32
    k: int,
    n_valid: Optional[int] = None,
    exclude: Optional[torch.Tensor] = None,  # (q, S) int ids per query
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (q, k) f32, ids (q, k) int64): the k best items per query
    by IEEE f32 inner product among the first ``n_valid`` items, never an
    id on the query's row of ``exclude``, scores descending, ties to the
    smallest id, +0.0 above -0.0. ``exclude`` entries outside [0, n_valid)
    are ignored, duplicates are allowed, and k <= n_valid - S; its rows
    need unit stride along S only (a column slice of a wider buffer does).

    CPU tensors take the plain :func:`mips_topk`; others launch kernel B or
    raise."""
    n = items.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if cuda_build.on_cpu(queries, items, exclude):
        return mips_topk(queries, items, k, n_valid, exclude)
    _check(queries, items, torch.float32, k, n_valid)
    out, tc_chunks = _launch(_FUSED, queries, (items.data_ptr(),), n, k, n_valid, exclude)
    mips_topk_fused.launches += 1
    mips_topk_fused.tc_launches += tc_chunks > 0
    return out


# kernel B launches, and those whose score stage ran on the tensor cores;
# chip_smoke reads and resets both
mips_topk_fused.launches = 0
mips_topk_fused.tc_launches = 0


def mips_topk_int8_fused(
    queries: torch.Tensor,  # (q, d) f32
    items: "QuantizedItems",  # values (n, d) int8, scales (n, 1) f32
    k: int,
    n_valid: Optional[int] = None,
    exclude: Optional[torch.Tensor] = None,  # (q, S) int ids per query
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mips_topk_fused` over int8 items: score = the f32 inner
    product of the query with ``float(values)``, times the row's scale
    after the sum (``anncur_tpu/ops/quantized.py::mips_topk_int8``). The
    int8 rows are streamed as int8 (16-byte copies when d % 16 == 0).

    CPU tensors take :func:`mips_topk_int8_plain`; others launch kernel
    B's int8 entry or raise."""
    values, scales = items.values, items.scales
    n = values.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if cuda_build.on_cpu(queries, values, scales, exclude):
        return mips_topk_int8_plain(queries, items, k, n_valid, exclude)
    _check(queries, values, torch.int8, k, n_valid)
    if scales.dtype != torch.float32 or scales.device != queries.device or scales.numel() != n or not scales.is_contiguous():
        raise ValueError(f"mips_topk_int8_fused: scales must be {n} contiguous f32 values on {queries.device}")
    out, _ = _launch(_INT8, queries, (values.data_ptr(), scales.data_ptr()), n, k, n_valid, exclude)
    mips_topk_int8_fused.launches += 1
    return out


mips_topk_int8_fused.launches = 0  # kernel B int8 launches; chip_smoke reads and resets it


def fused_mips_topk(queries, items, k, chunk: int = 4096, materialize_bytes: float = 6e9):
    """``anncur_tpu/ops/mips_pallas.py::fused_mips_topk`` on kernel B. The
    JAX version picks a materialised (q, n) score matrix or a streaming
    scan by ``materialize_bytes``; kernel B already scores queries in
    chunks whose score matrix fits its 256 MB scratch and keeps no (q, n)
    output, so both sizes take the same call and ``chunk`` and
    ``materialize_bytes`` are accepted for the signature only. Ids are
    int64."""
    return mips_topk_fused(queries, items, k)


def mips_topk_streaming(queries, items, k, chunk: int = 4096):
    """``anncur_tpu/ops/mips_pallas.py::mips_topk_streaming`` on kernel B:
    live memory is the (query chunk, n) score scratch, whatever ``chunk``
    (accepted for the signature only). Ids are int64."""
    return mips_topk_fused(queries, items, k)


def _check(queries, items, item_dtype, k, n_valid) -> None:
    if queries.device.type != "cuda" or items.device != queries.device:
        raise ValueError("mips_topk_fused: queries and items must lie on one CUDA device")
    if queries.dtype != torch.float32 or items.dtype != item_dtype:
        raise ValueError(f"mips_topk_fused: f32 queries and {item_dtype} items only, got {queries.dtype}/{items.dtype}")
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(f"mips_topk_fused: queries {tuple(queries.shape)} vs items {tuple(items.shape)}")
    # row-major and contiguous; the kernel takes 16-byte copies where the
    # rows allow them (d % 4 == 0 for f32, d % 16 == 0 for int8, 16-byte
    # aligned bases) and narrower ones otherwise, so no alignment is required
    if not (queries.is_contiguous() and items.is_contiguous()):
        raise ValueError("mips_topk_fused: queries and items must be contiguous")
    n = items.shape[0]
    if not 1 <= k <= n_valid <= n or queries.shape[0] < 1 or queries.shape[1] < 1:
        raise ValueError(f"mips_topk_fused needs 1 <= k <= n_valid <= n; got k={k} n_valid={n_valid} n={n}")


def _launch(entry, queries, item_ptrs, n, k, n_valid, exclude):
    """One call of ``entry`` (kernel B's f32 or int8 ``Entry``, whose item
    pointers are ``item_ptrs``): outputs and scratch allocated here, on the
    queries' device and current stream. Returns ((scores, ids), the chunks
    of queries whose score stage ran on the tensor cores)."""
    n_ex = check_exclude(exclude, queries.shape[0], k, n_valid)
    if n_ex:
        if exclude.device != queries.device:
            raise ValueError("mips_topk_fused: exclude must lie on the queries' device")
        exclude = exclude.long()  # the same tensor when it is int64
        if exclude.stride(1) != 1:
            exclude = exclude.contiguous()
    q, d = queries.shape
    dev = queries.device
    with torch.cuda.device(dev):
        if dev.index not in _INIT_DEVICES:  # the kernels' attributes, set on the current device
            _INIT.call()
            _INIT_DEVICES.add(dev.index)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(dev, stream, int(_SCRATCH_BYTES.function()(q, n_valid, k)))
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int64, device=dev)
        tc_chunks = ctypes.c_int(0)
        entry.call(
            queries.data_ptr(), *item_ptrs, out_s.data_ptr(), out_i.data_ptr(),
            exclude.data_ptr() if n_ex else None, n_ex, exclude.stride(0) if n_ex else 0,
            scratch.data_ptr(), scratch.numel(), q, n, d, k, n_valid, ctypes.byref(tc_chunks), stream,
        )
    return (out_s, out_i), tc_chunks.value


def _scratch(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """The cached scratch of this device and stream, at least ``nbytes``."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        _SCRATCH.pop(key, None)
        buf = _SCRATCH[key] = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return buf

