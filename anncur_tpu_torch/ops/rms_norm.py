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
places itself by ``cuda_build.on_cpu``: CPU tensors take the plain
composition (any dtype, autograd included), others the kernel, which takes
no input that records an autograd graph and raises on anything else.
"""

from __future__ import annotations

import torch

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops.cuda_build import F32, I32, I64, PTR

# the kernel holds a row in registers: 16-byte vectors, at most 8 a lane
# of one warp (csrc/rms_norm.cu, kMaxVecPerLane)
MAX_WIDTH = 2048
_RMS_NORM = cuda_build.Entry("rms_norm", "rms_norm", [PTR] * 3 + [I64, I32, I64, F32])


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm as the source computes it: normalised in f32, rounded to x's
    dtype, then times the weight."""
    xf = x.float()
    return weight * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rms_norm_plain` of bf16 ``x`` and ``weight`` in one pass on
    the card: each row read once, the result written once (a new contiguous
    tensor of x's shape)."""
    if cuda_build.on_cpu(x, weight):
        return rms_norm_plain(x, weight, eps)
    rows, width, stride = _check(x, weight)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    _RMS_NORM(x, x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, width, stride, float(eps))
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
    rows, width, stride = cuda_build.bf16_rows("rms_norm", "x", x, strided=True)
    if width > MAX_WIDTH:
        raise ValueError(f"rms_norm: x's width {width} is above {MAX_WIDTH}")
    if weight.device != x.device or tuple(weight.shape) != (width,) or not weight.is_contiguous() \
            or weight.data_ptr() % 16:
        raise ValueError(f"rms_norm: weight must be a contiguous ({width},) tensor on {x.device} on a 16-byte base")
    return rows, width, stride
