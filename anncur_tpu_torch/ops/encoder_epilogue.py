"""The encoder layer's elementwise work between its GEMMs
(``csrc/encoder_epilogue.cu``), and the plain compositions it replaces.

Replaces no TPU kernel: the JAX package leaves these ops to XLA. On the
card, eager PyTorch runs every bias add, GELU, residual add and f32
LayerNorm of ``models/bert.py::_encoder_layer`` as its own pass; these
kernels do a layer's in three memory-bound passes, each reading its
inputs once:

- :func:`bias_residual_layernorm` at both LayerNorms of the layer,
- :func:`bias_gelu` at the MLP input,
- :func:`bias_add3` at the q, k and v projections (in place).

Each keeps the plain composition's rounding points: the f32 bias rounded
to bf16, each sum rounded to bf16, the LayerNorm and the GELU in f32 and
rounded once. The ``*_plain`` functions are those compositions, the ops
``_encoder_layer`` runs off the fused path. Activations are bf16 rows of a
width that is a multiple of 8, contiguous on 16-byte bases; bias, scale
and shift are the f32 parameters of that width. The entries take CUDA
tensors only and raise on anything else; ``models/bert.py`` picks the
path.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from anncur_tpu_torch.ops import cuda_build

# the LayerNorm kernel holds a row in registers: 16-byte vectors, at most
# 16 a lane of one warp (csrc/encoder_epilogue.cu, kLnMaxVecPerLane)
MAX_LAYERNORM_WIDTH = 4096
_VECTOR = 8  # bf16 values a 16-byte vector


def bias_residual_layernorm_plain(mm, bias, residual, scale, shift, eps):
    """LayerNorm in f32 of ``residual + (mm + bias)``, cast back: the bias
    in ``mm``'s dtype, each sum in it."""
    s = residual + (mm + bias.to(mm.dtype))
    return F.layer_norm(s.float(), (s.shape[-1],), scale, shift, eps).to(mm.dtype)


def bias_gelu_plain(mm, bias, approximate: bool):
    """GELU of ``mm + bias`` (bias in ``mm``'s dtype): tanh's formula when
    ``approximate``, else erf's."""
    return F.gelu(mm + bias.to(mm.dtype), approximate="tanh" if approximate else "none")


def bias_add3_plain(q, k, v, bq, bk, bv):
    """``q += bq``, ``k += bk``, ``v += bv`` in place, each bias in its
    tensor's dtype; returns (q, k, v)."""
    for x, b in ((q, bq), (k, bk), (v, bv)):
        x.add_(b.to(x.dtype))
    return q, k, v


def bias_residual_layernorm(mm, bias, residual, scale, shift, eps):
    """:func:`bias_residual_layernorm_plain` in one pass: each row of
    ``mm`` and ``residual`` read once, the result written once (a new
    tensor). Widths up to :data:`MAX_LAYERNORM_WIDTH`."""
    width = _check_rows("bias_residual_layernorm", mm=mm, residual=residual)
    if width > MAX_LAYERNORM_WIDTH:
        raise ValueError(f"bias_residual_layernorm: width {width} is above {MAX_LAYERNORM_WIDTH}")
    if residual.shape != mm.shape or residual.device != mm.device:
        raise ValueError(
            f"bias_residual_layernorm: residual {tuple(residual.shape)} on {residual.device} is not mm's "
            f"{tuple(mm.shape)} on {mm.device}")
    _check_vectors("bias_residual_layernorm", mm, width, bias=bias, scale=scale, shift=shift)
    out = torch.empty_like(mm)
    lib = _lib("bias_residual_layernorm", 6, (ctypes.c_longlong, ctypes.c_int, ctypes.c_float))
    rc = lib.bias_residual_layernorm(
        mm.data_ptr(), bias.data_ptr(), residual.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        mm.numel() // width, width, float(eps), *_device_stream(mm),
    )
    cuda_build.check(lib, rc, "bias_residual_layernorm kernel")
    bias_residual_layernorm.launches += 1
    return out


bias_residual_layernorm.launches = 0  # chip_smoke reads and resets it


def bias_gelu(mm, bias, approximate: bool):
    """:func:`bias_gelu_plain` in one pass (a new tensor)."""
    width = _check_rows("bias_gelu", mm=mm)
    _check_vectors("bias_gelu", mm, width, bias=bias)
    out = torch.empty_like(mm)
    lib = _lib("bias_gelu", 3, (ctypes.c_longlong, ctypes.c_int, ctypes.c_int))
    rc = lib.bias_gelu(mm.data_ptr(), bias.data_ptr(), out.data_ptr(), mm.numel() // width, width,
                       int(bool(approximate)), *_device_stream(mm))
    cuda_build.check(lib, rc, "bias_gelu kernel")
    bias_gelu.launches += 1
    return out


bias_gelu.launches = 0


def bias_add3(q, k, v, bq, bk, bv):
    """:func:`bias_add3_plain` in one launch, in place; each of q, k, v
    with its own rows and width. Returns (q, k, v)."""
    widths = []
    for name, x, b in (("q", q, bq), ("k", k, bk), ("v", v, bv)):
        width = _check_rows("bias_add3", **{name: x})
        if x.device != q.device:
            raise ValueError(f"bias_add3: {name} is on {x.device}, q on {q.device}")
        _check_vectors("bias_add3", x, width, **{f"b{name}": b})
        widths.append(width)
    lib = _lib("bias_add3", 6, (ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 3)
    rc = lib.bias_add3(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bq.data_ptr(), bk.data_ptr(), bv.data_ptr(),
        *(x.numel() // w for x, w in zip((q, k, v), widths)), *widths, *_device_stream(q),
    )
    cuda_build.check(lib, rc, "bias_add3 kernel")
    bias_add3.launches += 1
    return q, k, v


bias_add3.launches = 0


def _check_rows(entry, **tensors) -> int:
    """The width of bf16 activations (their last dim), after checking each
    is a contiguous CUDA tensor on a 16-byte base, rows a multiple of 8
    wide; all of one width."""
    widths = set()
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{entry}: {name} is on {x.device}; the kernel takes CUDA tensors")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{entry}: {name} is {x.dtype}; the kernel takes bf16")
        if x.dim() < 1 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} must be contiguous on a 16-byte base")
        if x.shape[-1] <= 0 or x.shape[-1] % _VECTOR:
            raise ValueError(f"{entry}: {name}'s width {x.shape[-1]} is not a positive multiple of {_VECTOR}")
        widths.add(x.shape[-1])
    if len(widths) != 1:
        raise ValueError(f"{entry}: widths {sorted(widths)} differ")
    return widths.pop()


def _check_vectors(entry, x, width, **vectors) -> None:
    """f32 vectors of ``width`` on ``x``'s device, contiguous on 16-byte bases."""
    for name, t in vectors.items():
        if (
            t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != (width,)
            or not t.is_contiguous() or t.data_ptr() % 16
        ):
            raise ValueError(
                f"{entry}: {name} must be a contiguous ({width},) f32 tensor on {x.device} on a 16-byte base")


def _device_stream(x):
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(x.device).cuda_stream


def _lib(entry: str, n_ptrs: int, sizes) -> ctypes.CDLL:
    """``csrc/encoder_epilogue.cu``'s library with ``entry``'s signature
    set: ``n_ptrs`` pointers, ``sizes``, then device and stream."""
    lib = cuda_build.load("encoder_epilogue")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + list(sizes) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
