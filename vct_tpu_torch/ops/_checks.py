"""Checks and launch plumbing shared by the kernel wrappers: which device a
call is for, what a kernel takes (device, dtype, shape, contiguity, 16-byte
alignment), the current CUDA stream, and a launch's error code."""

from __future__ import annotations

import torch

SMEM_LIMIT = 232448  # bytes of shared memory one block may have on an H100 (csrc/mma_common.cuh)


def on_cuda(x: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    tensor (the kernel runs); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    return True


def expect(t: torch.Tensor, name: str, shape, dtype, device, *, vector_loads: bool = True
           ) -> None:
    """``vector_loads``: the kernel reads the tensor in 16-byte loads, so it
    must start on a 16-byte boundary."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vector_loads and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
