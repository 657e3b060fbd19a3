"""Tensor parallelism for the BERT towers (Megatron layout).

Counterpart of ``anncur_tpu/parallel/tp.py``. JAX annotates parameter
shardings and lets GSPMD insert the collectives; here the encoder layer
runs its own (``models/bert.py::_encoder_layer``). Per encoder layer,
over the ``model`` axis of the mesh:

- attention q/k/v kernels (h, h) and biases: column-parallel, each rank
  holds ``num_heads / tp`` heads and runs kernels A, C and D over them;
- attention output kernel (h, h): row-parallel, followed by an all-reduce
  over the ``model`` group, its bias added once after the reduce;
- MLP in kernel (h, i) and bias: column-parallel; out kernel (i, h):
  row-parallel, as the attention output;
- embeddings, layernorms, pooler and heads: replicated.

Where a column-parallel block begins, :func:`copy_to_tp` is the identity
forward and an all-reduce backward; after a row-parallel product,
:func:`reduce_from_tp` is an all-reduce forward and the identity
backward. So the replicated parameters get the same gradient on every
rank of the ``model`` group, and the sharded ones their own block's.

:func:`param_pspecs` gives each parameter the dim it is sharded along on
the ``model`` axis, or None (JAX's ``PartitionSpec`` reduced to that);
:func:`shard_params` keeps each rank's block. Checkpoints hold the full
parameters (:func:`gather_full`), so JAX's ``load_pytree`` reads them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

PSpecs = Dict[str, Optional[int]]  # parameter path -> shard dim on the model axis


def _bert_leaf_pspec(path: str, model_axis: str = "model") -> Optional[int]:
    """The shard dim of the leaf at ``path`` (``/``-separated, framed by
    ``/``): JAX's ``P(None, model)`` is 1, ``P(model)`` and ``P(model,
    None)`` are 0, ``P()`` is None. ``model_axis`` is kept for JAX's
    signature; a dim does not depend on the axis name."""
    last = path.strip("/").rsplit("/", 1)[-1]
    if "/attn/" in path:
        if last in ("q_kernel", "k_kernel", "v_kernel"):
            return 1
        if last in ("q_bias", "k_bias", "v_bias"):
            return 0
        if last == "out_kernel":
            return 0
        return None  # out_bias, layernorm
    if "/mlp/" in path:
        if last == "in_kernel":
            return 1
        if last == "in_bias":
            return 0
        if last == "out_kernel":
            return 0
        return None
    return None  # embeddings, pooler, heads


def _named(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def param_pspecs(params, model_axis: str = "model") -> PSpecs:
    """{path: shard dim or None} for a params tree (nested dicts and lists
    in the JAX layout), a dict of named parameters, or a module built by
    ``models/bert.py::params_module``."""
    # at call time: train/ imports the encoder, which imports this module
    from anncur_tpu_torch.train.checkpoint import flat_paths

    flat = _named(params) if isinstance(params, nn.Module) else flat_paths(params)
    return {path: _bert_leaf_pspec("/" + path + "/", model_axis) for path in flat}


def _layers(model: nn.Module):
    """The encoder layers' ModuleDicts (``attn`` and ``mlp``)."""
    return [m for m in model.modules() if isinstance(m, nn.ModuleDict) and set(m.keys()) == {"attn", "mlp"}]


def _block(t: torch.Tensor, dim: int, n: int, c: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} parameter does not split {n} ways")
    return t.chunk(n, dim)[c].contiguous()


@torch.no_grad()
def shard_params(model: nn.Module, mesh, model_axis: str = "model") -> PSpecs:
    """Keep each rank's block of the sharded parameters (in place) and hand
    every encoder layer the ``model`` group. Heads must split evenly.
    Returns the specs."""
    tp, c = mesh.shape[model_axis], mesh.coords[model_axis]
    spec = getattr(model, "spec", None)
    if spec is not None and spec.num_heads % tp:
        raise ValueError(f"{spec.num_heads} heads do not split over a model axis of {tp}")
    specs = param_pspecs(model, model_axis)
    for name, p in _named(model).items():
        if specs[name] is not None:
            p.data = _block(p.data, specs[name], tp, c)
    for layer in _layers(model):
        layer.tp_group = mesh.groups[model_axis]
    return specs


@torch.no_grad()
def gather_full(tensors: Dict[str, torch.Tensor], specs: PSpecs, mesh, model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """Full tensors from each rank's blocks (every rank calls it): the
    parameters, or anything keyed and shaped like them (Adam moments)."""
    group, tp = mesh.groups[model_axis], mesh.shape[model_axis]
    out = {}
    for name, t in tensors.items():
        d = specs.get(name)
        if d is None:
            out[name] = t.detach().clone()
            continue
        parts = [torch.empty_like(t) for _ in range(tp)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        out[name] = torch.cat(parts, dim=d)
    return out


@torch.no_grad()
def load_full_(tensors: Dict[str, torch.Tensor], full: Dict[str, Any], specs: PSpecs, mesh, model_axis: str = "model") -> None:
    """Copy this rank's block of each full value (array or tensor) into
    ``tensors``, in place; a name without a shard dim takes the whole value
    (so with no specs this is a plain copy, and ``mesh`` may be None)."""
    for name, t in tensors.items():
        val = torch.as_tensor(full[name])
        d = specs.get(name)
        if d is not None:
            val = _block(val, d, mesh.shape[model_axis], mesh.coords[model_axis])
        t.copy_(val)


def full_tree(template, flat: Dict[str, Any], prefix: str = ""):
    """``template``'s nested dict/list structure with each leaf replaced by
    ``flat[path]``."""
    if isinstance(template, dict):
        return {k: full_tree(v, flat, f"{prefix}/{k}" if prefix else str(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [full_tree(v, flat, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(template)]
    return flat[prefix]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Input of a column-parallel block: identity forward, all-reduce of the
    gradient over ``group`` backward."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Output of a row-parallel product: all-reduce (sum) forward over
    ``group``, identity backward."""
    return _ReduceFromTP.apply(x, group)
