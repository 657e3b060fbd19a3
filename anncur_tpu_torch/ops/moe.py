"""The sparse expert layer's pieces: routing, the expert-sorted row order,
the two dispatch passes (``csrc/moe_dispatch.cu``), the expert GEMMs, and
the plain versions of each.

Replaces no TPU kernel: the JAX package has no expert layer. A layer of
``models/deepseek_v2.py`` runs, for T tokens of width h, top k of E
experts:

1. :func:`route`: f32 logits and softmax over the experts, the top k
   (descending, ties to the lowest expert id, ``topk_stable``'s rule), the
   weights not renormalised and multiplied by the routed scaling factor;
2. :func:`sort_rows`: each (token, slot)'s row in an expert-sorted layout
   of T k rows, built on the device with no host sync: rows grouped by
   expert, tokens in order within a group (the grouped GEMMs take groups
   of any size, so none is padded);
3. :func:`moe_permute`: each token's row copied into its k rows;
4. :func:`expert_mlp`: gate and up, SwiGLU, down, as grouped GEMMs over
   the groups (``torch._grouped_mm``, cuBLAS/CUTLASS through PyTorch);
5. :func:`moe_combine`: each token's k rows weighted and summed in f32 in
   slot order, rounded, plus the shared experts' output, plus the residual.

Tokens are never dropped (no capacity factor). Each of :func:`moe_permute`,
:func:`expert_mlp` and :func:`moe_combine` places itself by
``cuda_build.on_cpu``: CPU tensors take the plain versions (the experts in
a loop), others the kernels, which raise on what they cannot take.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.nn import functional as F

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops.cuda_build import I32, I64, PTR
from anncur_tpu_torch.ops.mips import topk_stable

_PERMUTE = cuda_build.Entry("moe_dispatch", "moe_permute", [PTR] * 3 + [I64, I32, I32])
_COMBINE = cuda_build.Entry("moe_dispatch", "moe_combine", [PTR] * 6 + [I64, I32, I32])


class RowOrder(NamedTuple):
    """Where each (token, slot) goes in the expert-sorted layout."""

    dest: torch.Tensor  # (T * k,) int32: the row of slot i of token t at t * k + i
    ends: torch.Tensor  # (E,) int32: the end row of each expert's group (its start is the previous end)
    counts: torch.Tensor  # (E,) int64: rows each expert computes


def route(x: torch.Tensor, gate: torch.Tensor, top_k: int, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (T, k) int64, weights (T, k) f32) of ``x`` (T, h) under the router
    ``gate`` (E, h): softmax of the f32 logits, the k largest, descending,
    ties to the lowest id, times ``scale``."""
    probs = torch.softmax(x.float() @ gate.float().T, dim=-1)
    weights, ids = topk_stable(probs, top_k)
    return ids, weights * scale if scale != 1.0 else weights


def sort_rows(ids: torch.Tensor, n_experts: int) -> RowOrder:
    """The expert-sorted layout of ``ids`` (T, k), on their device, with no
    host sync (no ``bincount``, no ``.item()``)."""
    flat = ids.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=ids.device).scatter_add_(0, flat, torch.ones_like(flat))
    order = torch.sort(flat, stable=True).indices  # slots by expert, then by slot
    dest = torch.empty_like(order).scatter_(0, order, torch.arange(flat.numel(), device=ids.device))
    return RowOrder(dest.to(torch.int32), counts.cumsum(0).to(torch.int32), counts)


def moe_permute_plain(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """(T k, h): row ``dest[t k + i]`` is ``x``'s row t."""
    k = dest.numel() // x.shape[0]
    out = x.new_empty((dest.numel(), x.shape[1]))
    out[dest.long()] = x.repeat_interleave(k, dim=0)
    return out


def moe_combine_plain(y, dest, weights, shared, residual) -> torch.Tensor:
    """(T, h): ``residual + (bf16(Σ_i weights[t, i] y[dest[t k + i]]) +
    shared)``, the sum in f32 in slot order, each product and sum rounded
    apart, the rest in the activations' dtype."""
    t, k = weights.shape
    rows = y[dest.long()].view(t, k, -1).float()
    acc = rows[:, 0] * weights[:, :1]
    for i in range(1, k):
        acc = acc + rows[:, i] * weights[:, i:i + 1]
    return residual + (acc.to(y.dtype) + shared)


def moe_permute(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """:func:`moe_permute_plain` in one pass on the card."""
    if cuda_build.on_cpu(x, dest):
        return moe_permute_plain(x, dest)
    k = _check_dispatch("moe_permute", x, dest, x.shape[0])
    out = torch.empty((dest.numel(), x.shape[1]), dtype=x.dtype, device=x.device)
    _PERMUTE(x, x.data_ptr(), dest.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], k)
    moe_permute.launches += 1
    return out


moe_permute.launches = 0


def moe_combine(y, dest, weights, shared, residual) -> torch.Tensor:
    """:func:`moe_combine_plain` in one pass on the card, bit for bit."""
    if cuda_build.on_cpu(y, dest, weights, shared, residual):
        return moe_combine_plain(y, dest, weights, shared, residual)
    t = residual.shape[0]
    k = _check_dispatch("moe_combine", y, dest, t)
    for name, a in (("shared", shared), ("residual", residual)):
        cuda_build.bf16_rows("moe_combine", name, a, device=y.device)
        if a.shape != (t, y.shape[1]):
            raise ValueError(f"moe_combine: {name} {tuple(a.shape)} is not ({t}, {y.shape[1]})")
    if weights.dtype != torch.float32 or tuple(weights.shape) != (t, k) or not weights.is_contiguous() \
            or weights.device != y.device:
        raise ValueError(f"moe_combine: weights must be a contiguous ({t}, {k}) f32 tensor on {y.device}")
    out = torch.empty_like(residual)
    _COMBINE(y, y.data_ptr(), dest.data_ptr(), weights.data_ptr(), shared.data_ptr(), residual.data_ptr(),
             out.data_ptr(), t, y.shape[1], k)
    moe_combine.launches += 1
    return out


moe_combine.launches = 0


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of a (rows, 2 w) [gate | up] product, in its dtype."""
    width = gate_up.shape[-1] // 2
    return F.silu(gate_up[..., :width]) * gate_up[..., width:]


def expert_mlp_plain(xs: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor, order: RowOrder) -> torch.Tensor:
    """(T k, h): each expert's SwiGLU over its group's rows, one product
    at a time."""
    out = xs.new_empty((xs.shape[0], w_down.shape[-1]))
    ends = order.ends.tolist()
    for e, (end, n) in enumerate(zip(ends, order.counts.tolist())):
        if n:
            out[end - n:end] = swiglu(xs[end - n:end] @ w_gate_up[e]) @ w_down[e]
    return out


def expert_mlp(xs: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor, order: RowOrder) -> torch.Tensor:
    """Each expert's SwiGLU over its group of ``xs`` (T k, h): ``w_gate_up``
    (E, h, 2 w), ``w_down`` (E, w, h). On the card two grouped GEMMs over
    the groups (the SwiGLU between them plain ops), which take bf16 rows."""
    if cuda_build.on_cpu(xs, w_gate_up, w_down, order.ends):
        return expert_mlp_plain(xs, w_gate_up, w_down, order)
    cuda_build.bf16_rows("expert_mlp", "xs", xs)
    return torch._grouped_mm(swiglu(torch._grouped_mm(xs, w_gate_up, offs=order.ends)), w_down, offs=order.ends)


def _check_dispatch(entry, rows_t, dest, n_tokens) -> int:
    """k, after checking the rows tensor (2-D bf16 rows on the card) and
    ``dest`` ((n_tokens k,) int32 on its device)."""
    cuda_build.bf16_rows(entry, "rows", rows_t)
    if rows_t.dim() != 2:
        raise ValueError(f"{entry}: rows must be 2-D, got {tuple(rows_t.shape)}")
    if dest.dtype != torch.int32 or dest.dim() != 1 or not dest.is_contiguous() or dest.device != rows_t.device \
            or n_tokens <= 0 or dest.numel() % n_tokens:
        raise ValueError(f"{entry}: dest must be a contiguous 1-D int32 tensor of tokens x k on {rows_t.device}")
    return dest.numel() // n_tokens

