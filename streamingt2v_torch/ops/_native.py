"""Build and load the hand-written CUDA kernels (``streamingt2v_torch/csrc``).

Each source compiles with its own ``nvcc`` for ``sm_90a`` (all started
together), and the objects link into one shared library with a plain C
interface, loaded through ``ctypes``.  The build runs at first use,
into ``streamingt2v_torch/_build/<hash>/``, where the hash covers the sources
and the compiler flags, so an edited source rebuilds and an unchanged one
loads the cached library.  Nothing here runs at import time: the CPU-only
tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from streamingt2v_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_attention.cu", "geglu_ff.cu", "temporal_conv.cu", "fused_group_norm.cu",
           "temporal_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libst2v_kernels.so"
# the `dtype` argument of every exported function
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported functions (all return a cudaError_t as int).
_SIGNATURES = {
    "st2v_flash_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P], _I),
    "st2v_flash_attention_packed": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P,
                                     _P], _I),
    "st2v_fused_group_norm": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
    "st2v_group_norm_affine": ([_P] * 6 + [_I] * 6 + [_F, _I, _P], _I),
    "st2v_temporal_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "st2v_geglu_ff": ([_P] * 10 + [_I] * 8 + [_P], _I),
    "st2v_temporal_conv": ([_P] * 8 + [_I] * 9 + [_P], _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the library if it is not cached; returns (path, seconds, log),
    the log being nvcc's (ptxas's lines too) of the build that made it.
    One nvcc per source, all running at once, then one link."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        saved = out_dir / "ptxas.log"
        return lib, 0.0, saved.read_text() if saved.exists() else "cached"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [out_dir / (Path(src).stem + ".o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([nvcc, "-shared", "-o", tmp, *map(str, objs)], capture_output=True,
                          text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    (out_dir / "ptxas.log").write_text(log)
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call).  A build that
    compiles counts in ``kernel_builds``, and its seconds in
    ``kernel_build_s`` (``utils/profiling``)."""
    with span("st2v.kernel_build"):
        path, seconds, _ = build()
    count("kernel_builds", int(seconds > 0))
    count("kernel_build_s", seconds)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The device's SM count (the persistent kernels' grid cap)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t, copied if its data does not start on 16 bytes (the kernels' vector
    loads)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()
