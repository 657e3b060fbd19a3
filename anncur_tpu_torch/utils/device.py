"""Device resolution for the port's entry points, device identity, and
the true-f32 matmul scope."""

from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but
    absent. There is no silent move to the CPU: a caller that wants the
    CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether ``a`` and ``b`` name one device: ``cuda`` without an index
    is the current CUDA device (``cuda`` and ``cuda:0`` are one there)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


@contextlib.contextmanager
def true_f32():
    """cuBLAS f32 matmuls without TF32 inside, whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
