"""Attention forward: kernel A (``csrc/attention.cu``) and its plain version.

Replaces ``anncur_tpu/models/bert.py::_flash_attention`` (the stock
Pallas TPU flash-attention forward). Every encoder layer of the port's
CE forward calls :func:`attention`, the final layer's 1- or 3-row query
slice included. Layout is the JAX one: q ``(b, g, nh, hd)`` with
``g <= s``, k and v ``(b, s, nh, hd)``, ``key_valid`` ``(b, s)`` bool; the
result is ``(b, g, nh, hd)`` in q's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from anncur_tpu_torch.ops import cuda_build

_HEAD_DIMS = (16, 32, 64, 128)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use


def attention_plain(q, k, v, key_valid):
    """einsum, mask, softmax, einsum, all in f32 on the JAX layout
    (``anncur_tpu/models/bert.py::_attn_core``); cast to q's dtype."""
    hd = q.shape[-1]
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
    bias = torch.where(key_valid, 0.0, -1e9).to(torch.float32)
    probs = torch.softmax(scores + bias[:, None, None, :], dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs, v.float()).to(q.dtype)


def attention(q, k, v, key_valid):
    """softmax(QKᵀ/√hd + bias) V with bias -1e9 at invalid keys.

    CPU tensors take :func:`attention_plain`; CUDA tensors launch kernel A
    or raise."""
    tensors = (q, k, v, key_valid)
    if all(t.device.type == "cpu" for t in tensors):
        return attention_plain(q, k, v, key_valid)
    _check(q, k, v, key_valid)
    b, g, nh, hd = q.shape
    s = k.shape[1]
    out = torch.empty((b, g, nh, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, g, s, nh, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        key_valid.stride(0), 1.0 / math.sqrt(hd),
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, rc, "attention kernel")
    attention.launches += 1
    return out


attention.launches = 0  # kernel A launches; chip_smoke reads and resets it


def _check(q, k, v, key_valid) -> None:
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, key_valid)):
        raise ValueError("attention: q, k, v and key_valid must all lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: q/k/v must share bf16 or f32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if key_valid.dtype != torch.bool:
        raise ValueError(f"attention: key_valid must be bool, got {key_valid.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, g, nh, hd = q.shape
    s = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != q.shape[2:] or g > s:
        raise ValueError(f"attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if tuple(key_valid.shape) != (b, s) or key_valid.stride(1) != 1:
        raise ValueError(f"attention: key_valid must be a row-contiguous ({b}, {s}) tensor")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"attention: head dim {hd} not in {_HEAD_DIMS}")
    es = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"attention: {name} must be contiguous along the head dim")
        if t.data_ptr() % 16 or any((t.stride(i) * es) % 16 for i in range(3)):
            raise ValueError(f"attention: {name} rows must be 16-byte aligned")
    smem = 2 * s * hd * es + 4 * s
    if smem > _MAX_SMEM:
        raise ValueError(f"attention: s={s}, hd={hd} needs {smem} B of shared memory")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attention")
    fn = lib.attention_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 10 + [ctypes.c_float, i32, ptr]
        fn.restype = i32
    return lib
