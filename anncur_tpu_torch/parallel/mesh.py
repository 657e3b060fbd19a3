"""Process-group meshes: the counterpart of ``anncur_tpu/parallel/mesh.py``
on ``torch.distributed``.

JAX's ``Mesh`` is a grid of devices with named axes. Here there is one
rank per device, and a :class:`Mesh` is the grid of ranks with named
axes: for each axis, this rank's process group along it (the ranks that
differ from it only in that coordinate). It gives what the JAX mesh gives
its callers: ``mesh.shape[name]``, the axis sizes by name; ``mesh.coords
[name]``, this rank's index on each axis; and ``mesh.device``, this
rank's device (``cuda:<LOCAL_RANK>`` under NCCL, the CPU under gloo).

The mesh is a small dataclass over ``dist.new_group`` rather than
``torch.distributed.device_mesh.DeviceMesh``: DeviceMesh's ``shape`` is a
tuple, and how it makes its per-dimension groups on the CPU has changed
between PyTorch releases, while ``new_group`` behaves the same under gloo
and NCCL in every release the port runs on. A mesh always spans every
rank of the world; a shape over fewer ranks raises (JAX takes the first
devices).

Collectives run on the mesh's device: a CUDA tensor over NCCL, a CPU
tensor over gloo. Nothing falls back: a collective that fails raises,
and every group has a timeout (``DEFAULT_TIMEOUT_S``), so a rank that
stops answering fails the others instead of hanging them.

``require_accelerator`` has no counterpart: ``utils/device.py::
resolve_device`` raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anncur_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ranks with named axes, one rank per device."""

    shape: Dict[str, int]  # axis name -> size, in axis order (JAX's mesh.shape)
    ranks: np.ndarray  # the global ranks laid out on the grid
    coords: Dict[str, int]  # this rank's index on each axis
    groups: Dict[str, Any]  # this rank's process group along each axis
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """Ranks in the mesh (JAX's ``mesh.devices.size``)."""
        return int(self.ranks.size)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _timeout(timeout_s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(timeout_s))


def group_device() -> torch.device:
    """This rank's device in the default group: its CUDA device under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def ensure_process_group(device: Optional[DeviceLike] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """The default process group, started if there is none, and this rank's
    device. Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) it
    is :func:`multihost.init_distributed`'s; in a plain process it is a
    1-rank group on an in-process store (NCCL for ``device`` on the card,
    the default, gloo for ``device="cpu"``). A group that exists already
    must be on ``device``'s type."""
    if dist.is_initialized():
        dev = group_device()
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"the process group runs on {dev}, not on {device}")
        return dev
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from anncur_tpu_torch.parallel.multihost import init_distributed

        return init_distributed(device, timeout_s)
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        _backend_for(dev), store=dist.HashStore(), rank=0, world_size=1, timeout=_timeout(timeout_s)
    )
    return dev


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = ("data",),
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """A mesh of ``shape`` over every rank of the world, ranks laid out in
    row-major order (as JAX lays out its devices). Every rank must call it,
    with the same arguments, in the same order as its other meshes."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    dev = ensure_process_group(device)
    world = dist.get_world_size()
    n_needed = int(np.prod(shape))
    if n_needed > world:
        raise ValueError(f"mesh shape {shape} needs {n_needed} devices, have {world}")
    if n_needed < world:
        raise ValueError(
            f"mesh shape {shape} covers {n_needed} of the {world} ranks: a mesh spans every rank"
        )
    ranks = np.arange(world).reshape(shape)
    me = dist.get_rank()
    coord = np.unravel_index(me, shape)
    groups: Dict[str, Any] = {}
    for ax, name in enumerate(names):
        if shape[ax] == world:
            groups[name] = dist.group.WORLD
            continue
        # every rank creates every line's group, in the same order
        for line in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
            group = dist.new_group([int(r) for r in line], timeout=_timeout(DEFAULT_TIMEOUT_S))
            if me in line:
                groups[name] = group
    return Mesh(
        shape=dict(zip(names, shape)),
        ranks=ranks,
        coords={name: int(c) for name, c in zip(names, coord)},
        groups=groups,
        device=dev,
    )


def default_mesh(axis_name: str = "data", device: Optional[DeviceLike] = None) -> Mesh:
    """1-D mesh over every rank (JAX: over every local device). In a plain
    process with no group it starts a 1-rank one (:func:`ensure_process_group`)."""
    ensure_process_group(device)
    return make_mesh((dist.get_world_size(),), (axis_name,), device)


@contextlib.contextmanager
def mesh_session(device: Optional[DeviceLike] = None, axis_name: str = "data") -> Iterator[Mesh]:
    """:func:`default_mesh` for the length of a ``with`` block; the process
    group is destroyed at its end when this call started it, so a command
    run inside another program leaves no group behind."""
    started = not dist.is_initialized()
    mesh = default_mesh(axis_name, device)
    try:
        yield mesh
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous slice of every leaf's leading dim (the
    balanced split of :func:`multihost.process_range`), on its device."""
    from anncur_tpu_torch.parallel.multihost import process_range

    n, c = mesh.shape[axis], mesh.coords[axis]

    def take(x):
        x = _as_tensor(x)
        start, end = process_range(x.shape[0], n, c)
        return x[start:end].to(mesh.device)

    return _tree_map(take, tree)


def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank: tensors and arrays broadcast to each
    rank's device; a CPU ``torch.Generator`` carries rank 0's state. Other
    leaves (ints, None) are kept as each rank passed them. Every rank
    passes leaves of the same shapes and dtypes."""

    def bcast(x):
        if isinstance(x, torch.Generator):
            state = x.get_state().to(mesh.device)
            dist.broadcast(state, src=0)
            out = torch.Generator(device=x.device)
            out.set_state(state.cpu())
            return out
        if torch.is_tensor(x) or isinstance(x, np.ndarray):
            t = _as_tensor(x).to(mesh.device, copy=True).contiguous()
            dist.broadcast(t, src=0)
            return t
        return x

    return _tree_map(bcast, tree)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) along ``axis``, concatenated
    along ``dim`` in the axis's order."""
    n = mesh.shape[axis]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


class _AllGatherGrad(torch.autograd.Function):
    """All-gather along dim 0 whose backward returns, to each rank, the sum
    over ranks of the gradient of its own block (an all-reduce, then this
    rank's slice: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows: (ctx.rank + 1) * ctx.rows], None


def all_gather_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` (same shape on each), in group order, with
    gradients flowing back to the rank that owns each block."""
    return _AllGatherGrad.apply(x, group)
