"""Build ``vct_tpu_torch/csrc/*.cu`` with ``nvcc`` and load it with ctypes.

The library is compiled at first use into ``vct_tpu_torch/_build/<hash>/``
(git-ignored), keyed by a hash of the sources, their shared headers
(``*.cuh``) and the compiler flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Each source
is compiled by its own ``nvcc`` process, all started together, and the objects
are linked into one library. The sources have a plain C interface and include
no PyTorch header, which keeps a build to seconds. Nothing here runs at import
time.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong


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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
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
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objects = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objects)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = any(proc.returncode for proc in procs)
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = link.returncode != 0
        for obj in objects:
            obj.unlink(missing_ok=True)
        load_library.build_seconds = time.perf_counter() - t0
        load_library.build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{load_library.build_log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.vct_decode_step.argtypes = [_I, _P] + [_I] * 11 + [_P]
    lib.vct_decode_step.restype = _I
    lib.vct_gen_argmax.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [_P]
    lib.vct_gen_argmax.restype = _I
    lib.vct_gen_argmax_plan.argtypes = [_I] * 5 + [_IP]
    lib.vct_gen_argmax_plan.restype = _I
    lib.vct_stack_step.argtypes = [_I, _P] + [_I] * 10 + [_P]
    lib.vct_stack_step.restype = _I
    lib.vct_stack_step_plan.argtypes = [_I] * 6 + [_IP]
    lib.vct_stack_step_plan.restype = _I
    lib.vct_whole_step.argtypes = [_I, _P] + [_I] * 11 + [_P]
    lib.vct_whole_step.restype = _I
    lib.vct_whole_step_plan.argtypes = [_I] * 7 + [_IP]
    lib.vct_whole_step_plan.restype = _I
    lib.vct_multi_step.argtypes = [_I, _P] + [_I] * 16 + [_P]
    lib.vct_multi_step.restype = _I
    lib.vct_multi_step_plan.argtypes = [_I] * 7 + [_IP]
    lib.vct_multi_step_plan.restype = _I
    lib.vct_decode_multi.argtypes = [_I, _P] + [_I] * 18 + [_P]
    lib.vct_decode_multi.restype = _I
    lib.vct_sequence_decode.argtypes = [_I, _P] + [_I] * 16 + [_P]
    lib.vct_sequence_decode.restype = _I
    lib.vct_sequence_decode_plan.argtypes = [_I] * 7 + [_IP]
    lib.vct_sequence_decode_plan.restype = _I
    lib.vct_gen_topk_blocks.argtypes = [_I]
    lib.vct_gen_topk_blocks.restype = _I
    lib.vct_gen_topk.argtypes = [_I] + [_P] * 12 + [_I] * 5 + [_P]
    lib.vct_gen_topk.restype = _I
    lib.vct_gen_topk_plan.argtypes = [_I] * 6 + [_IP]
    lib.vct_gen_topk_plan.restype = _I
    lib.vct_sce_block_rows.argtypes = [_I]
    lib.vct_sce_block_rows.restype = _I
    lib.vct_sce_stats_plan.argtypes = [_I] * 6 + [_IP]
    lib.vct_sce_stats_plan.restype = _I
    lib.vct_sce_softmax_stats.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [_P]
    lib.vct_sce_softmax_stats.restype = _I
    lib.vct_sce_clipped_stats.argtypes = [_I] + [_P] * 7 + [_I] * 4 + [_P]
    lib.vct_sce_clipped_stats.restype = _I
    lib.vct_sce_backward.argtypes = [_I] + [_P] * 12 + [_I] * 5 + [_P]
    lib.vct_sce_backward.restype = _I
    lib.vct_sce_backward_plan.argtypes = [_I] * 6 + [_IP]
    lib.vct_sce_backward_plan.restype = _I
    lib.vct_attn_forward.argtypes = [_I] + [_P] * 7 + [_I] * 5 + [_IP, _F, _F, _I, _P]
    lib.vct_attn_forward.restype = _I
    lib.vct_attn_forward_plan.argtypes = [_I] * 5 + [_IP]
    lib.vct_attn_forward_plan.restype = _I
    lib.vct_attn_backward.argtypes = [_I] + [_P] * 11 + [_I] * 5 + [_IP, _F, _F, _I, _P]
    lib.vct_attn_backward.restype = _I
    lib.vct_attn_backward_plan.argtypes = [_I] * 5 + [_IP]
    lib.vct_attn_backward_plan.restype = _I
    lib.vct_embed_gather.argtypes = [_I, _I] + [_P] * 3 + [_I] * 4 + [_P]
    lib.vct_embed_gather.restype = _I
    lib.vct_embed_grad_plan.argtypes = [_I] * 3 + [_IP]
    lib.vct_embed_grad_plan.restype = _I
    lib.vct_embed_grad.argtypes = [_I] + [_P] * 4 + [_I] * 4 + [_P]
    lib.vct_embed_grad.restype = _I
    lib.vct_moe_route_smem.argtypes = [_I] * 3
    lib.vct_moe_route_smem.restype = _I
    lib.vct_moe_route.argtypes = [_P, _P] + [_I] * 3 + [_P] * 6
    lib.vct_moe_route.restype = _I
    lib.vct_grouped_gemm.argtypes = [_I] + [_P] * 6 + [_I] * 5 + [_P]
    lib.vct_grouped_gemm.restype = _I
    lib.vct_adam_capacity.argtypes = []
    lib.vct_adam_capacity.restype = _I
    lib.vct_adam_plan.argtypes = [_LL, _I, _IP]
    lib.vct_adam_plan.restype = _I
    lib.vct_adam_update.argtypes = [_I, ctypes.POINTER(ctypes.c_ulonglong),
                                    ctypes.POINTER(_LL), _P] + [_F] * 6 + [_P]
    lib.vct_adam_update.restype = _I
    return lib
