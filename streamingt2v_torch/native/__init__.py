"""The port's native y4m feeder (counterpart of ``streamingt2v_tpu/native``).

``AsyncVideoWriter`` wraps ``media_feeder.cpp``: uint8 RGB frames are
copied into a queue and a background thread converts them to BT.601
full-range YUV 4:2:0 and writes a YUV4MPEG2 stream, with the arithmetic of
the Python writer in ``utils/media.py`` (the same bytes).  The library is
built with ``g++`` at first use into ``streamingt2v_torch/_build/<hash>/``
(the hash covers the source and the flags), never beside its source; without
a compiler ``available()`` is false and ``utils/media.py`` writes in Python.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "media_feeder.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
# no fused multiply-add: each product and sum rounds as numpy's do
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")
LIB_NAME = "libmediafeeder.so"


def build() -> Path:
    """The feeder library, compiled if it is not cached."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_ROOT / f"feeder-{h}" / LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native y4m feeder needs a C++ compiler")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders each install a whole library
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.mfw_open.restype = ctypes.c_void_p
    lib.mfw_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
    lib.mfw_submit.restype = ctypes.c_int
    lib.mfw_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.mfw_pending.restype = ctypes.c_int
    lib.mfw_pending.argtypes = [ctypes.c_void_p]
    lib.mfw_close.restype = ctypes.c_int
    lib.mfw_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the feeder builds and loads here."""
    try:
        load_library()
    except (OSError, RuntimeError):
        return False
    return True


class AsyncVideoWriter:
    """Non-blocking y4m writer of (N, H, W, 3) uint8 RGB frames; ``close``
    (or leaving the ``with`` block) waits for the queue to drain."""

    def __init__(self, path: str, width: int, height: int, fps: int = 24):
        self._lib = load_library()
        self._handle = self._lib.mfw_open(os.fsencode(path), width, height, fps, 1)
        if not self._handle:
            raise RuntimeError(f"cannot open {path} at {width}x{height} (even sizes only)")
        self.width, self.height = width, height

    def write(self, frames: np.ndarray) -> None:
        frames = np.ascontiguousarray(frames)
        if frames.dtype != np.uint8 or frames.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"expected (N, {self.height}, {self.width}, 3) uint8 frames, got "
                             f"{frames.dtype} {frames.shape}")
        if self._lib.mfw_submit(self._handle, frames.ctypes.data, frames.shape[0]) != 0:
            raise IOError("the y4m feeder refused the frames (a write failed)")

    @property
    def pending(self) -> int:
        return self._lib.mfw_pending(self._handle)

    def close(self) -> None:
        if self._handle:
            rc = self._lib.mfw_close(self._handle)
            self._handle = None
            if rc != 0:
                raise IOError(f"the y4m feeder reported a failed write ({rc})")

    def __enter__(self) -> "AsyncVideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
