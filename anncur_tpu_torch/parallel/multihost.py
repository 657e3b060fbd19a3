"""Multi-process execution: the process group of a ``torchrun`` launch,
meshes over it, balanced row ranges, and host values replicated from
rank 0.

Counterpart of ``anncur_tpu/parallel/multihost.py``. The reference scales
training with PyTorch-Lightning DDP (models/pairwise_trainer.py:241-249)
and the offline build with mention-range chunk jobs recombined from files
(eval/combine_chunked_computations.py:125-250). Here both run on
``torch.distributed``, one process per device:

- training: every rank runs the same Trainer over a mesh of all ranks
  (``train/trainer.py``); it takes its slice of each micro-batch, and the
  gradients are all-reduced before the optimizer;
- offline build: ranks own contiguous mention ranges and write chunk files
  into a shared directory, and rank 0 combines them
  (``indexer/score_matrix.py::ScoreMatrixBuilder.build_multihost``).

:func:`init_distributed` is the counterpart of ``jax.distributed.
initialize``: it reads the environment ``torchrun`` sets.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anncur_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    Mesh,
    _as_tensor,
    _backend_for,
    _timeout,
    ensure_process_group,
    group_device,
    make_mesh,
    replicate,
)
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device

LOGGER = logging.getLogger(__name__)

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: Optional[DeviceLike] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on ``cuda:<LOCAL_RANK>`` (the default), gloo for
    ``device="cpu"``, with a timeout on every collective. Returns this
    rank's device; a process already in a group keeps it."""
    if dist.is_initialized():
        return group_device()
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed needs {', '.join(missing)} in the environment (run under torchrun)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        _backend_for(dev), init_method="env://", rank=rank, world_size=world, timeout=_timeout(timeout_s)
    )
    LOGGER.info("rank %d/%d on %s (%s)", rank, world, dev, dist.get_backend())
    return dev


def global_mesh(axis_names=("data",), shape=None, device: Optional[DeviceLike] = None) -> Mesh:
    """Mesh over every rank (call after :func:`init_distributed`). Default:
    1-D over everything."""
    ensure_process_group(device)
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return make_mesh(shape, axis_names, device)


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_range(n: int, n_proc: Optional[int] = None, pid: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous balanced [start, end) row range owned by this process
    (first ``n % n_proc`` processes get one extra row)."""
    rank, size = world()
    n_proc = size if n_proc is None else n_proc
    pid = rank if pid is None else pid
    base, extra = divmod(n, n_proc)
    start = pid * base + min(pid, extra)
    return start, start + base + (1 if pid < extra else 0)


def global_batch_from_local(mesh: Mesh, tree: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's LOCAL portion of a global batch on its device. JAX
    assembles a global array from the portions; here each rank computes on
    its own portion and the collectives that need the others' rows gather
    them (the in-batch loss, the gradient all-reduce)."""
    return {k: _as_tensor(v).to(mesh.device) for k, v in tree.items()}


def replicate_from_host(mesh: Mesh, tree):
    """Rank 0's host values on every rank (``mesh.py::replicate``); a CPU
    ``torch.Generator`` carries rank 0's state, the counterpart of JAX's
    typed-PRNG-key case."""
    return replicate(tree, mesh)


def broadcast_object(obj, src: int = 0):
    """``src``'s picklable ``obj`` on every rank (itself without a group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier(name: str) -> None:
    """Cross-process sync point (no-op in a 1-rank world). ``name`` labels
    the log line."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        LOGGER.debug("barrier %s", name)
        dist.barrier()
