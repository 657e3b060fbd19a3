"""RMSNorm in one pass (``csrc/rms_norm.cu``), and the plain composition
it replaces.

Replaces no TPU kernel: the JAX package has no decoder model. The norm is
``models/deepseek_v2.py``'s, as the source computes it: normalised in f32,
rounded to the activations' dtype, then times the weight. Eager PyTorch
runs :func:`rms_norm_plain` as seven passes over the rows; :func:`rms_norm`
reads each row once and writes it once, keeping the composition's rounding
points (only the order of the f32 sum of squares differs).

The kernel takes bf16 rows of a width that is a multiple of 8, up to
:data:`MAX_WIDTH`, each row contiguous, rows one stride apart (a multiple
of 8 elements, on a 16-byte base): ``ckv[..., :512]`` of 576-wide rows is
read where it lies. The weight is a bf16 vector of the width. The entry
takes CUDA tensors only, with no autograd graph to record, and raises on
anything else; ``models/deepseek_v2.py`` picks the path by the device.
"""

from __future__ import annotations

import ctypes

import torch

from anncur_tpu_torch.ops import cuda_build

# the kernel holds a row in registers: 16-byte vectors, at most 8 a lane
# of one warp (csrc/rms_norm.cu, kMaxVecPerLane)
MAX_WIDTH = 2048
_VECTOR = 8  # bf16 values a 16-byte vector


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm as the source computes it: normalised in f32, rounded to x's
    dtype, then times the weight."""
    xf = x.float()
    return weight * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rms_norm_plain` of bf16 ``x`` and ``weight`` in one pass on
    the card: each row read once, the result written once (a new contiguous
    tensor of x's shape)."""
    rows, width, stride = _check(x, weight)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    lib = cuda_build.load("rms_norm")
    if lib.rms_norm.argtypes is None:
        lib.rms_norm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                                         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.rms_norm.restype = ctypes.c_int
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    rc = lib.rms_norm(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, width, stride, float(eps), dev,
                      torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "rms_norm kernel")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0  # chip_smoke reads and resets it


def within_one_ulp(got: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float):
    """(every element of ``got`` within one bf16 ulp of the plain
    composition of bf16 ``x`` and ``weight``, share of elements with its
    bits). Within one ulp: the weight times the plain composition's
    normalised value or one of its two bf16 neighbours, rounded once (the
    kernel's f32 row sum differs from PyTorch's in order alone, which moves
    the normalised value by one bf16 ulp at most)."""
    xf = x.float()
    z = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(torch.bfloat16)
    del xf
    gb, zb = got.view(torch.int16), z.view(torch.int16)
    same = gb == (weight * z).view(torch.int16)
    ok = same.clone()
    for step in (1, -1):  # one step away from 0 for either sign, one toward it (±0's: a NaN)
        ok |= gb == (weight * (zb + step).view(torch.bfloat16)).view(torch.int16)
    return bool(ok.all()), float(same.float().mean())


def _check(x, weight):
    """(rows, width, row stride in elements) of ``x``, after checking what
    the kernel takes."""
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise ValueError(f"rms_norm: x is {x.dtype} and weight {weight.dtype}; the kernel takes bf16")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise ValueError("rms_norm: an input requires grad; the kernel has no backward")
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: x is on {x.device}; the kernel takes CUDA tensors")
    if x.dim() < 1 or not 0 < x.shape[-1] <= MAX_WIDTH or x.shape[-1] % _VECTOR:
        raise ValueError(f"rms_norm: x's width {tuple(x.shape)[-1:]} is not a multiple of {_VECTOR} "
                         f"up to {MAX_WIDTH}")
    width = x.shape[-1]
    if weight.device != x.device or tuple(weight.shape) != (width,) or not weight.is_contiguous() \
            or weight.data_ptr() % 16:
        raise ValueError(f"rms_norm: weight must be a contiguous ({width},) tensor on {x.device} on a 16-byte base")
    try:
        rows = x.view(-1, width)  # a view: the leading dims as rows of one stride
    except RuntimeError as err:
        raise ValueError(f"rms_norm: x {tuple(x.shape)} with strides {x.stride()} is not rows of one stride") from err
    stride = rows.stride(0) if rows.shape[0] > 1 else width
    if rows.stride(1) != 1 or stride < width or stride % _VECTOR or x.data_ptr() % 16:
        raise ValueError(f"rms_norm: x's rows must be contiguous, a multiple of {_VECTOR} elements apart, "
                         "on a 16-byte base")
    return rows.shape[0], width, stride
