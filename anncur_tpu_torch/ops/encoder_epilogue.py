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
and shift are the f32 parameters of that width. Each entry places itself
by ``cuda_build.on_cpu``: CPU tensors take the plain composition, others
the kernel, which raises on anything it cannot take.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops.cuda_build import F32, I32, I64, PTR

# the LayerNorm kernel holds a row in registers: 16-byte vectors, at most
# 16 a lane of one warp (csrc/encoder_epilogue.cu, kLnMaxVecPerLane)
MAX_LAYERNORM_WIDTH = 4096
_LAYERNORM = cuda_build.Entry("encoder_epilogue", "bias_residual_layernorm", [PTR] * 6 + [I64, I32, F32])
_GELU = cuda_build.Entry("encoder_epilogue", "bias_gelu", [PTR] * 3 + [I64, I32, I32])
_ADD3 = cuda_build.Entry("encoder_epilogue", "bias_add3", [PTR] * 6 + [I64] * 3 + [I32] * 3)


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
    if cuda_build.on_cpu(mm, bias, residual, scale, shift):
        return bias_residual_layernorm_plain(mm, bias, residual, scale, shift, eps)
    rows, width, _ = cuda_build.bf16_rows("bias_residual_layernorm", "mm", mm)
    if width > MAX_LAYERNORM_WIDTH:
        raise ValueError(f"bias_residual_layernorm: width {width} is above {MAX_LAYERNORM_WIDTH}")
    cuda_build.bf16_rows("bias_residual_layernorm", "residual", residual, device=mm.device)
    if residual.shape != mm.shape:
        raise ValueError(f"bias_residual_layernorm: residual {tuple(residual.shape)} is not mm's {tuple(mm.shape)}")
    _check_vectors("bias_residual_layernorm", mm, width, bias=bias, scale=scale, shift=shift)
    out = torch.empty_like(mm)
    _LAYERNORM(mm, mm.data_ptr(), bias.data_ptr(), residual.data_ptr(), scale.data_ptr(), shift.data_ptr(),
               out.data_ptr(), rows, width, float(eps))
    bias_residual_layernorm.launches += 1
    return out


bias_residual_layernorm.launches = 0  # chip_smoke reads and resets it


def bias_gelu(mm, bias, approximate: bool):
    """:func:`bias_gelu_plain` in one pass (a new tensor)."""
    if cuda_build.on_cpu(mm, bias):
        return bias_gelu_plain(mm, bias, approximate)
    rows, width, _ = cuda_build.bf16_rows("bias_gelu", "mm", mm)
    _check_vectors("bias_gelu", mm, width, bias=bias)
    out = torch.empty_like(mm)
    _GELU(mm, mm.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, width, int(bool(approximate)))
    bias_gelu.launches += 1
    return out


bias_gelu.launches = 0


def bias_add3(q, k, v, bq, bk, bv):
    """:func:`bias_add3_plain` in one launch, in place; each of q, k, v
    with its own rows and width. Returns (q, k, v)."""
    if cuda_build.on_cpu(q, k, v, bq, bk, bv):
        return bias_add3_plain(q, k, v, bq, bk, bv)
    rows, widths = [], []
    for name, x, b in (("q", q, bq), ("k", k, bk), ("v", v, bv)):
        n, width, _ = cuda_build.bf16_rows("bias_add3", name, x, device=q.device)
        _check_vectors("bias_add3", x, width, **{f"b{name}": b})
        rows.append(n)
        widths.append(width)
    _ADD3(q, q.data_ptr(), k.data_ptr(), v.data_ptr(), bq.data_ptr(), bk.data_ptr(), bv.data_ptr(), *rows, *widths)
    bias_add3.launches += 1
    return q, k, v


bias_add3.launches = 0


def _check_vectors(entry, x, width, **vectors) -> None:
    """f32 vectors of ``width`` on ``x``'s device, contiguous on 16-byte bases."""
    for name, t in vectors.items():
        if (
            t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != (width,)
            or not t.is_contiguous() or t.data_ptr() % 16
        ):
            raise ValueError(
                f"{entry}: {name} must be a contiguous ({width},) f32 tensor on {x.device} on a 16-byte base")

