"""Exact MIPS top-k: kernel B (``csrc/mips_topk.cu``).

Replaces ``anncur_tpu/ops/mips_pallas.py::_mips_kernel`` and
``::_maxmask_kernel``. The fixed-anchor query runs its latent projection
+ top-k_retvr stage through :func:`mips_topk_fused`, and the adaptive
engine every candidate pick, with the query's scored ids excluded. Its
plain version is ``ops/mips.py::mips_topk``.

On the card it is a register-tiled f32 FFMA GEMM into a score scratch,
then an exact radix select, one thread-block cluster per query; any
``1 <= k <= n_valid - S``, as ``lax.top_k`` takes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Set, Tuple

import torch

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops.mips import check_exclude, mips_topk

# score scratch by (device index, stream): one allocation, grown as needed
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_INIT_DEVICES: Set[int] = set()


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

    CPU tensors take the plain :func:`mips_topk`; CUDA tensors launch
    kernel B or raise."""
    n = items.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    if queries.device.type == "cpu" and items.device.type == "cpu":
        return mips_topk(queries, items, k, n_valid, exclude)
    _check(queries, items, k, n_valid)
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
        lib = _lib(dev.index)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(dev, stream, int(lib.mips_topk_scratch_bytes(q, n_valid, k)))
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int64, device=dev)
        rc = lib.mips_topk_fused(
            queries.data_ptr(), items.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            exclude.data_ptr() if n_ex else None, n_ex, exclude.stride(0) if n_ex else 0,
            scratch.data_ptr(), scratch.numel(), q, n, d, k, n_valid, stream,
        )
    cuda_build.check(lib, rc, "mips_topk kernel")
    mips_topk_fused.launches += 1
    return out_s, out_i


mips_topk_fused.launches = 0  # kernel B launches; chip_smoke reads and resets it


def _check(queries, items, k, n_valid) -> None:
    if queries.device.type != "cuda" or items.device != queries.device:
        raise ValueError("mips_topk_fused: queries and items must lie on one CUDA device")
    if queries.dtype != torch.float32 or items.dtype != torch.float32:
        raise ValueError(f"mips_topk_fused: f32 only, got {queries.dtype}/{items.dtype}")
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(f"mips_topk_fused: queries {tuple(queries.shape)} vs items {tuple(items.shape)}")
    if not (queries.is_contiguous() and items.is_contiguous()):
        raise ValueError("mips_topk_fused: queries and items must be contiguous")
    n = items.shape[0]
    if not 1 <= k <= n_valid <= n or queries.shape[0] < 1 or queries.shape[1] < 1:
        raise ValueError(f"mips_topk_fused needs 1 <= k <= n_valid <= n; got k={k} n_valid={n_valid} n={n}")


def _scratch(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """The cached scratch of this device and stream, at least ``nbytes``."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        _SCRATCH.pop(key, None)
        buf = _SCRATCH[key] = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return buf


def _lib(device: int) -> ctypes.CDLL:
    """The kernel library, its attributes set on ``device`` (current)."""
    lib = cuda_build.load("mips_topk")
    if lib.mips_topk_fused.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64 = ctypes.c_longlong
        lib.mips_topk_fused.argtypes = [ptr] * 5 + [i32, i64, ptr, i64] + [i32] * 5 + [ptr]
        lib.mips_topk_fused.restype = i32
        lib.mips_topk_scratch_bytes.argtypes = [i32] * 3
        lib.mips_topk_scratch_bytes.restype = ctypes.c_longlong
        lib.mips_topk_init.argtypes = []
        lib.mips_topk_init.restype = i32
    if device not in _INIT_DEVICES:
        cuda_build.check(lib, lib.mips_topk_init(), "mips_topk kernel attributes")
        _INIT_DEVICES.add(device)
    return lib
