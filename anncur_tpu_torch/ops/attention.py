"""Attention: kernel A forward (``csrc/attention.cu``), kernels C and D
backward (``csrc/attention_bwd.cu``), and their plain versions.

Replaces ``anncur_tpu/models/bert.py::_flash_attention``: the stock
Pallas TPU flash-attention forward and, under ``jax.grad``, its backward
(``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``). Every
encoder layer of the port's CE calls :func:`attention`, the final layer's
1- or 3-row query slice included. Layout is the JAX one: q ``(b, g, nh,
hd)`` with ``g <= s``, k and v ``(b, s, nh, hd)``, ``key_valid`` ``(b, s)``
bool; the result is ``(b, g, nh, hd)`` in q's dtype.

Each entry takes its place by ``cuda_build.on_cpu``, the rule every entry
of ``ops/`` follows: CPU tensors take the plain versions (autograd
differentiates :func:`attention_plain`); any other call launches the
kernels, which raise on what they cannot take. There a call that needs a
gradient goes through :class:`AttentionFunction`: kernel A also writes the
row log-sum-exp, and the backward launches kernel D (dQ, and D = rowsum(dO
* O)), then kernel C (dK, dV). A call without one launches kernel A alone.

The kernels take every head dim that is a multiple of 16: up to 256
through bodies templated on it, above 256 through a wide route with the
head dim a runtime count (``csrc/attention_wide.cuh``). :func:`attention`
zero-pads q, k and v of any other width to the next multiple of 16 (zero
columns add nothing to QKᵀ and give zero output columns), keeps the
softmax scale at 1/√(real hd), and slices the output and the gradients
back, so it takes every head dim that JAX's ``_attn_core`` takes.

The decoder cross-encoder (``models/deepseek_v2.py``) calls it with
``causal=True`` (a mode of kernel A's ``mma.sync`` body, built at hd 192
alone: key tiles past a query tile's last row are never read, keys past a
row's position score -inf), its own softmax scale, and v narrower than q
and k.
"""

from __future__ import annotations

import math

import torch

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops.cuda_build import F32, I32, I64, PTR

# head dims the kernels take are multiples of this (csrc/attention_common.cuh
# up to 256, csrc/attention_wide.cuh above)
_HEAD_DIM_UNIT = 16
# the one head dim of the causal body (DeepSeek-V2-Lite's qk head dim, 128 +
# 64); narrower causal heads are zero-padded to it
CAUSAL_HEAD_DIM = 192

# kernel A's entries: q, k, v, key_valid, out, lse, then _geometry's values;
# kernels D and C: nine pointers, then _bwd_geometry's
_FWD_ARGS = [PTR] * 6 + [I32] * 6 + [I64] * 10 + [F32]
_BWD_ARGS = [PTR] * 9 + [I32] * 6 + [I64] * 16 + [F32]
_FWD = cuda_build.Entry("attention", "attention_fwd", _FWD_ARGS)
_FWD_CAUSAL = cuda_build.Entry("attention", "attention_fwd_causal", _FWD_ARGS)
_DQ = cuda_build.Entry("attention_bwd", "attention_bwd_dq", _BWD_ARGS)
_DKV = cuda_build.Entry("attention_bwd", "attention_bwd_dkv", _BWD_ARGS)


def attention_plain(q, k, v, key_valid, causal: bool = False, scale=None):
    """einsum, mask, softmax, einsum, all in f32 on the JAX layout
    (``anncur_tpu/models/bert.py::_attn_core``); cast to q's dtype. ``scale``
    multiplies QKᵀ (default: divided by √hd). ``causal`` (g = s): keys past
    a query's own position score -inf, on top of the -1e9 of invalid keys.
    v may be narrower than q and k; the output takes its width."""
    hd = q.shape[-1]
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    bias = torch.where(key_valid, 0.0, -1e9).to(torch.float32)
    scores = scores + bias[:, None, None, :]
    if causal:
        g, s = q.shape[1], k.shape[1]
        if g != s:
            raise ValueError(f"causal attention takes g = s, got g={g}, s={s}")
        ahead = torch.ones(g, s, dtype=torch.bool, device=q.device).triu_(1)
        scores = scores.masked_fill(ahead, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", probs, v.float()).to(q.dtype)


def attention_delta_plain(dout, out):
    """``D = rowsum(dO * O)``, (b, nh, g) f32: JAX's ``di``
    (``flash_attention.py:273``), the plain version of what kernel D writes."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def attention_bwd_plain(q, k, v, key_valid, dout):
    """(dQ, dK, dV) in q's dtype: the autograd of :func:`attention_plain`,
    the plain version of kernels C and D."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain(*leaves, key_valid)
        return torch.autograd.grad(out, leaves, dout)


def attention(q, k, v, key_valid, causal: bool = False, scale=None):
    """softmax(QKᵀ · scale + bias) V with bias -1e9 at invalid keys; ``scale``
    defaults to 1/√hd. ``causal`` (g = s) also hides each query's later
    keys (the decoder's layers; no backward; on the card q and k at most
    ``CAUSAL_HEAD_DIM`` wide, zero-padded to it). v may be narrower than q
    and k (latent attention's 128 against 192): it is zero-padded to their
    width, which adds zero output columns, and the output sliced back.

    CPU tensors take :func:`attention_plain`; others launch kernel A (and,
    when a gradient is needed, kernels C and D in backward) or raise."""
    if cuda_build.on_cpu(q, k, v, key_valid):
        return attention_plain(q, k, v, key_valid, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if causal or scale is not None or v.shape[-1] != q.shape[-1]:
            raise ValueError("attention: the backward kernels take the default scale, equal widths, not causal")
        return AttentionFunction.apply(q, k, v, key_valid)
    hd, hv = q.shape[-1], v.shape[-1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    q, k, v = _pad_head_dim(q, k, v, causal)
    return attention_fwd(q, k, v, key_valid, causal=causal, scale=scale)[0][..., :hv]


attention.launches = 0  # kernel A launches; chip_smoke reads and resets it


def _pad_head_dim(q, k, v, causal: bool = False):
    """q, k, v zero-padded along the head dim to the width the kernels take
    for q's: ``CAUSAL_HEAD_DIM`` for causal heads no wider than it, else the
    next multiple of 16. A tensor already that wide is itself; v narrower
    than q is padded to the same width."""
    hd = q.shape[-1]
    width = CAUSAL_HEAD_DIM if causal and hd <= CAUSAL_HEAD_DIM else hd + -hd % _HEAD_DIM_UNIT
    return tuple(t if t.shape[-1] >= width else torch.nn.functional.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))


class AttentionFunction(torch.autograd.Function):
    """Kernel A forward with the row log-sum-exp saved; kernels D then C
    backward, two launches: D also writes ``D = rowsum(dO * O)`` (JAX
    computes it outside Pallas, ``flash_attention.py:273-275``), which C
    reads. dO goes to the kernels with its strides; only one they cannot
    take (a broadcast, or rows off 16 bytes) is copied. A head dim that is
    not a multiple of 16 runs zero-padded (the padded output and dO columns
    are zero, so D is unchanged); the outputs and gradients are sliced
    back."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        hd = q.shape[-1]
        q, k, v = _pad_head_dim(q, k, v)
        ctx.hd, ctx.scale = hd, 1.0 / math.sqrt(hd)
        out, lse = attention_fwd(q, k, v, key_valid, with_lse=True, scale=ctx.scale)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out[..., :hd]

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        hd = ctx.hd
        if q.shape[-1] != hd:
            dout = torch.nn.functional.pad(dout, (0, q.shape[-1] - hd))
        elif not _rows_ok(dout):
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, delta = attention_bwd_dq(q, k, v, key_valid, dout, out, lse, scale=ctx.scale)
        dk, dv = attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta, scale=ctx.scale)
        return dq[..., :hd], dk[..., :hd], dv[..., :hd], None


def attention_fwd(q, k, v, key_valid, causal: bool = False, with_lse: bool = False, scale=None):
    """Kernel A: ``(out, lse)``; ``lse`` is the (b, nh, g) f32 row
    log-sum-exp when ``with_lse``, else None. ``scale`` multiplies QKᵀ
    (default 1/√hd of q's head dim). ``causal``: bf16, g = s, hd
    ``CAUSAL_HEAD_DIM``, no lse (the mma.sync body's causal instantiation)."""
    _check(q, k, v, key_valid)
    b, g, nh, hd = q.shape
    s = k.shape[1]
    if causal and (q.dtype != torch.bfloat16 or g != s or hd != CAUSAL_HEAD_DIM or with_lse):
        raise ValueError(f"attention: causal takes bf16, g = s, hd {CAUSAL_HEAD_DIM} and no lse; got {q.dtype}, "
                         f"g={g}, s={s}, hd={hd}, with_lse={with_lse}")
    out = torch.empty((b, g, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nh, g), dtype=torch.float32, device=q.device) if with_lse else None
    (_FWD_CAUSAL if causal else _FWD)(
        q, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *_geometry(q, k, v, key_valid, scale),
    )
    attention.launches += 1
    return out, lse


def attention_bwd_dq(q, k, v, key_valid, dout, out, lse, scale=None):
    """Kernel D: ``(dQ, delta)``: dQ (b, g, nh, hd) in q's dtype and
    ``delta = rowsum(dout * out)`` (b, nh, g) f32, which kernel C reads.
    From the forward's inputs, its output ``out`` and its (b, nh, g) f32
    ``lse``, and ``dout``; ``dout`` and ``out`` (b, g, nh, hd) with any
    strides that keep hd contiguous and rows on 16 bytes. ``scale`` as the
    forward's. CPU tensors take :func:`attention_bwd_plain` and
    :func:`attention_delta_plain`."""
    if cuda_build.on_cpu(q, k, v, key_valid, dout, out, lse):
        return attention_bwd_plain(q, k, v, key_valid, dout)[0], attention_delta_plain(dout, out)
    _check_bwd(q, k, v, key_valid, dout, lse)
    _check_rows("out", out, q)
    b, g, nh, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b, nh, g), dtype=torch.float32, device=q.device)
    _DQ(
        q, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), dout.data_ptr(), out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_bwd_geometry(q, k, v, key_valid, dout, out, scale),
    )
    attention_bwd_dq.launches += 1
    return dq, delta


attention_bwd_dq.launches = 0  # kernel D launches


def attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta, scale=None):
    """Kernel C: ``(dK, dV)``, each (b, s, nh, hd) in q's dtype, from the
    forward's inputs, ``dout`` (strides as :func:`attention_bwd_dq` takes
    them), ``lse`` and kernel D's ``delta`` (both (b, nh, g) f32); launch
    it after D on the same stream. CPU tensors take
    :func:`attention_bwd_plain`."""
    if cuda_build.on_cpu(q, k, v, key_valid, dout, lse, delta):
        return attention_bwd_plain(q, k, v, key_valid, dout)[1:]
    _check_bwd(q, k, v, key_valid, dout, lse)
    _check_stats("delta", delta, q)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    _DKV(
        q, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_geometry(q, k, v, key_valid, dout, None, scale),
    )
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0  # kernel C launches


def _geometry(q, k, v, key_valid, scale=None):
    """The C entries' arguments after the pointers: dtype flag, sizes,
    strides (in elements), scale (default 1/√hd)."""
    b, g, nh, hd = q.shape
    return (
        int(q.dtype == torch.bfloat16), b, g, k.shape[1], nh, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        key_valid.stride(0), 1.0 / math.sqrt(hd) if scale is None else scale,
    )


def _bwd_geometry(q, k, v, key_valid, dout, out, scale=None):
    """The backward entries' arguments after the pointers: those of
    :func:`_geometry` with dO's and O's (b, g, nh) strides (O's zero when
    ``out`` is None) before the scale."""
    geo = _geometry(q, k, v, key_valid, scale)
    o_strides = (0, 0, 0) if out is None else tuple(out.stride()[:3])
    return (*geo[:16], *dout.stride()[:3], *o_strides, geo[16])


def _rows_ok(t) -> bool:
    """Whether the backward kernels take ``t``'s layout as it is: hd
    contiguous, the other strides nonzero multiples of 16 bytes, the base
    on 16 bytes."""
    es = t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and (t.stride(i) * es) % 16 == 0 for i in range(3)
    )


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
    if hd <= 0 or hd % _HEAD_DIM_UNIT:
        raise ValueError(
            f"attention: head dim {hd} is not a positive multiple of {_HEAD_DIM_UNIT} "
            "(the kernels' rule; attention() zero-pads other widths)"
        )
    es = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"attention: {name} must be contiguous along the head dim")
        if t.data_ptr() % 16 or any((t.stride(i) * es) % 16 for i in range(3)):
            raise ValueError(f"attention: {name} rows must be 16-byte aligned")
    # both bodies stream K and V in 64-key tiles, so s is not bounded here


def _check_bwd(q, k, v, key_valid, dout, lse) -> None:
    """What kernels C and D take beyond the forward's inputs: ``dout``
    shaped and typed like q on its device (:func:`_check_rows`) and a
    contiguous (b, nh, g) f32 ``lse``."""
    _check(q, k, v, key_valid)
    _check_rows("dout", dout, q)
    _check_stats("lse", lse, q)


def _check_rows(name, t, q) -> None:
    if t is None or t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not _rows_ok(t):
        raise ValueError(
            f"attention backward: {name} must be a {tuple(q.shape)} {q.dtype} tensor on {q.device} with hd "
            "contiguous and its other strides nonzero multiples of 16 bytes"
        )


def _check_stats(name, t, q) -> None:
    b, g, nh, _ = q.shape
    if (
        t is None or tuple(t.shape) != (b, nh, g) or t.dtype != torch.float32
        or t.device != q.device or not t.is_contiguous()
    ):
        raise ValueError(f"attention backward: {name} must be a contiguous ({b}, {nh}, {g}) f32 tensor on {q.device}")

