"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``anncur_tpu_torch/build/lib<name>-<hash>.so``
at first use (the hash covers the source, every local header it
includes and the flags, so an edited source or header rebuilds) and
loaded with ``ctypes``. The compiler's report (``ptxas -v``: registers,
spills and shared memory of each kernel) is kept beside the library as
``<library>.log``. Nothing is compiled or loaded at import: the CPU tests
import every module without ``nvcc``.

It is also the one seam between ``ops/`` and the kernels: each C entry is
declared once (:class:`Entry`), :func:`on_cpu` is the one rule for where
an entry of ``ops/`` runs (no model chooses by device), and
:func:`bf16_rows` the one check of the activation rows the epilogue,
RMSNorm and MoE kernels take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNEL_SOURCES = tuple(sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _sources(name: str) -> Dict[str, bytes]:
    """``<name>.cu`` and every header it includes with quotes, transitively:
    their contents by path relative to ``CSRC_DIR``."""
    found: Dict[str, bytes] = {}
    todo = [f"{name}.cu"]
    while todo:
        rel = todo.pop()
        if rel in found:
            continue
        with open(os.path.join(CSRC_DIR, rel), "rb") as fin:
            found[rel] = fin.read()
        for inc in _LOCAL_INCLUDE.findall(found[rel]):
            todo.append(os.path.normpath(os.path.join(os.path.dirname(rel), inc.decode())))
    return found


def library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for rel, text in sorted(_sources(name).items()):
        h.update(rel.encode() + b"\0" + text)
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Compile every missing library of ``names``, one ``nvcc`` each, all
    started together. Returns the wall seconds spent; raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running: List[Tuple[str, str, str, subprocess.Popen]] = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            with open(f"{out}.log", "w") as fout:
                fout.write(log)
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if code != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


# the C types of the entries' arguments
PTR, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
DEVICE_STREAM = (I32, PTR)  # the tail of a launch: device index, stream
STREAM = (PTR,)  # kernel B's: its entries launch on the current device


def on_cpu(*tensors) -> bool:
    """The one rule for where an entry of ``ops/`` runs: True when every
    tensor argument (None skipped) lies on the CPU, where the entry
    computes its plain composition. Otherwise it launches its kernel, whose
    checks raise on what the kernel cannot take (mixed devices, a dtype, a
    recorded autograd graph it has no backward for): on the card an entry
    never gives way to its plain version."""
    for t in tensors:
        if t is not None and not t.is_cpu:
            return False
    return True


class Entry:
    """A C entry of ``csrc/<source>.cu``, declared by its source, its name
    and the types of its arguments; ``tail`` are the types after them: the
    device index and stream that :meth:`__call__` appends, or what the
    caller passes to :meth:`call` (kernel B's ``STREAM``). The library is
    resolved through :func:`load` on every call, so a variant swapped into
    ``_LOADED`` is called instead; each library's function gets its types
    at first use."""

    def __init__(self, source: str, name: str, argtypes, tail=DEVICE_STREAM, restype=I32):
        self.source, self.name, self.restype = source, name, restype
        self.argtypes = [*argtypes, *tail]

    def function(self):
        """The entry in the library :func:`load` gives now, its types set."""
        fn = getattr(_LOADED.get(self.source) or load(self.source), self.name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = self.argtypes, self.restype
        return fn

    def __call__(self, x: torch.Tensor, *args) -> None:
        """Launch: ``args``, then the device index and current stream of
        ``x``, the tensor the launch belongs to; a non-zero return raises
        through :func:`check`."""
        dev = x.device
        rc = self.function()(*args, dev.index if dev.index is not None else torch.cuda.current_device(),
                             torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            check(load(self.source), rc, f"{self.name} kernel")

    def call(self, *args) -> None:
        """Launch with ``args`` as given, tail included; a non-zero return
        raises through :func:`check`."""
        rc = self.function()(*args)
        if rc:
            check(load(self.source), rc, f"{self.name} kernel")


VECTOR = 8  # bf16 values a 16-byte vector


def bf16_rows(entry: str, name: str, x: torch.Tensor, device=None, strided: bool = False) -> Tuple[int, int, int]:
    """(rows, width, row stride in elements) of ``x``, after checking the
    activation rows a kernel of ``entry`` takes: bf16 on a CUDA device
    (``device`` when given), a width that is a positive multiple of
    :data:`VECTOR`, each row contiguous on a 16-byte base, and the rows one
    after another or, with ``strided``, one stride apart, a multiple of
    :data:`VECTOR` (``ckv[..., :512]`` of 576-wide rows). An error names the
    entry, the tensor and what failed."""
    if not x.is_cuda or (device is not None and x.device != device):
        raise ValueError(f"{entry}: {name} is on {x.device}; the kernel takes CUDA tensors"
                         + ("" if device is None else f" on {device}"))
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{entry}: {name} is {x.dtype}; the kernel takes bf16")
    width = x.shape[-1] if x.dim() else 0
    if width <= 0 or width % VECTOR:
        raise ValueError(f"{entry}: {name}'s width {width} is not a positive multiple of {VECTOR}")
    if not strided:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} must be contiguous on a 16-byte base")
        return x.numel() // width, width, width
    try:
        rows = x.view(-1, width)  # a view: the leading dims as rows of one stride
    except RuntimeError as err:
        raise ValueError(f"{entry}: {name} {tuple(x.shape)} with strides {x.stride()} is not rows of one stride") \
            from err
    stride = rows.stride(0) if rows.shape[0] > 1 else width
    if rows.stride(1) != 1 or stride < width or stride % VECTOR or x.data_ptr() % 16:
        raise ValueError(f"{entry}: {name}'s rows must be contiguous, a multiple of {VECTOR} elements apart, "
                         "on a 16-byte base")
    return rows.shape[0], width, stride
