"""Build ``vct_tpu_torch/csrc/*.cu`` with ``nvcc`` and load it with ctypes.

The library is compiled at first use into ``vct_tpu_torch/_build/<hash>/``
(git-ignored), keyed by a hash of the sources and the compiler flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. The sources
have a plain C interface and include no PyTorch header, which keeps a build to
seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; the result is kept for
    the life of the process. ``load_library.build_log`` holds the compiler's
    output (register and shared-memory use per kernel) and
    ``load_library.build_seconds`` the build time (0 when loaded as built)."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libvct_kernels.so"
    load_library.build_seconds = 0.0
    load_library.build_log = ""
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libvct_kernels.{os.getpid()}.so"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())],
            capture_output=True, text=True)
        load_library.build_seconds = time.perf_counter() - t0
        load_library.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{load_library.build_log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.vct_decode_step.argtypes = [_I, _P] + [_I] * 11 + [_P]
    lib.vct_decode_step.restype = _I
    lib.vct_gen_argmax.argtypes = [_I] + [_P] * 7 + [_I] * 3 + [_P]
    lib.vct_gen_argmax.restype = _I
    return lib
