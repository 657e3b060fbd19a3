"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``anncur_tpu_torch/build/lib<name>-<hash>.so``
at first use (the hash covers the source, every local header it
includes and the flags, so an edited source or header rebuilds) and
loaded with ``ctypes``. The compiler's report (``ptxas -v``: registers,
spills and shared memory of each kernel) is kept beside the library as
``<library>.log``. Nothing is compiled or loaded at import: the CPU tests
import every module without ``nvcc``.
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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNEL_SOURCES = ("attention", "attention_bwd", "mips_topk", "encoder_epilogue", "moe_dispatch", "rms_norm")
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
