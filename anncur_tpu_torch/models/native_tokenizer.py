"""ctypes bridge to the native C++ WordPiece tokenizer.

Counterpart of ``anncur_tpu/models/native_tokenizer.py``: a drop-in
accelerator for :class:`anncur_tpu_torch.models.tokenizer.
WordPieceTokenizer`. ASCII texts go through the C++ fast path
(``native/wordpiece.cpp``); a text with non-ASCII bytes goes through the
Python WordPiece, so the ids are byte-identical by construction.

The library is built from that source with ``g++`` at first use, into
``anncur_tpu_torch/build/libwordpiece-<hash>.so`` (the hash covers the
source and the flags), as ``ops/cuda_build.py`` builds the kernels; the
JAX package's ``native/`` directory is only read. A failed build or load
raises: there is no silent fall back to the Python path. The fast path
is not taken (``native_available`` is False, and the Python path gives
the ids) only where it would give other ids: a cased tokenizer or a
vocabulary with id gaps.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from typing import List, Optional

from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.ops.cuda_build import BUILD_DIR

LOGGER = logging.getLogger(__name__)

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native", "wordpiece.cpp"
)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(SOURCE, "rb") as fin:
        h = hashlib.sha1(" ".join(CXX_FLAGS).encode() + b"\0" + fin.read())
    return os.path.join(BUILD_DIR, f"libwordpiece-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path. Raises with
    the compiler's output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native tokenizer needs a C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native tokenizer build failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.wp_destroy.restype = None
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_tokenize.restype = ctypes.c_int
        lib.wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _LIB = lib
    return _LIB


class NativeWordPieceTokenizer(WordPieceTokenizer):
    """Same API as WordPieceTokenizer; ``encode()`` uses C++ where it can."""

    MAX_IDS = 8192

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._lib = load_library()
        self._handle = None
        if not self.basic.do_lower_case:
            # wordpiece.cpp lowercases unconditionally
            LOGGER.warning("do_lower_case=False: the native fast path is lowercase-only; using Python")
            return
        # the C side assigns ids by array position: a vocab with id gaps
        # would shift every id after the gap
        ids = sorted(self.vocab.values())
        if ids != list(range(len(ids))):
            LOGGER.warning("vocab ids are not dense 0..%d; using Python", len(ids) - 1)
            return
        ordered = [t for t, _ in sorted(self.vocab.items(), key=lambda kv: kv[1])]
        arr = (ctypes.c_char_p * len(ordered))(*[t.encode("utf-8") for t in ordered])
        self._handle = self._lib.wp_create(arr, len(ordered), self.vocab[self.unk_token], self.max_chars_per_word)
        if not self._handle:
            raise RuntimeError("wp_create returned no tokenizer")
        self._buf = (ctypes.c_int * self.MAX_IDS)()

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def encode(self, text: str) -> List[int]:
        if self._handle is not None and not any(s in text for s in self.never_split):
            # a NUL would end the C string early; the Python path drops it
            text = text.replace("\x00", "")
            n = self._lib.wp_tokenize(self._handle, text.encode("utf-8", "ignore"), self._buf, self.MAX_IDS)
            if n >= 0:
                return list(self._buf[:n])
            # -1: non-ASCII, -2: more than MAX_IDS ids: the Python path
        return super().encode(text)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.wp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
