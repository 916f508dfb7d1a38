"""Adam's update of a param group as one CUDA kernel (``csrc/adam_update.cu``),
beside its plain PyTorch version.

Replaces no TPU kernel: the JAX package's update (``optax.adam`` /
``optax.adamw``, ``vct_tpu/train/optimizers.py``) is plain XLA. On the card
torch's capturable multi-tensor Adam, which a CUDA graph of the train step
can capture, makes eight passes over float32 tensors of every parameter's
size (80 bytes a parameter, with a float32 copy of ``exp_avg_sq`` in between);
the kernel makes one (28 bytes: p, g, m and v read, p, m and v written).

* ``adam_update(params, grads, exp_avgs, exp_avg_sqs, steps, *, lr, betas,
  eps, weight_decay)``: one Adam step of float32 tensors in place, each
  tensor's 0-dim float32 ``step`` advanced by one, with the arithmetic of
  torch's capturable branch in float32 (t = step + 1; ``m.lerp_(g, 1 - b1)``;
  ``v = b2 v + (1 - b2) g g``; ``p += m / ((sqrt(v) / sqrt(1 - b2^t) + eps) /
  (lr / (b1^t - 1)))``, b^t in float32; with ``weight_decay`` the decoupled
  decay ``p *= 1 - lr wd`` first). CPU tensors take ``adam_update_reference``,
  the same expression in PyTorch; CUDA tensors take the kernel or raise (a
  dtype other than float32, a tensor that is not contiguous or does not start
  on a 16-byte boundary, a tensor on another device, an ``lr`` that is not a
  0-dim float32 tensor on the card). ``lr`` and the steps are read on the
  device, so a CUDA graph's replay sees values filled in after its capture.
* The launches: the group in parts of at most ``vct_adam_capacity()``
  tensors (512 with CUDA 12.1 or later), each an update whose
  ``update_blocks`` blocks take the part's 16-byte units (each tensor's
  elements rounded up to 4, end to end) in tiles of ``TILE`` in turn
  (``block_tiles``), then one block that advances the steps.

The wrapper counts its launches (one a part, the update and the step count
together) in ``adam_update.launches`` and the elements it updated in
``adam_update.elements``; a graph replay adds what its capture counted
(``graphs.counters``).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple, Union

import torch

from vct_tpu_torch.ops._checks import expect as _expect
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda
from vct_tpu_torch.ops._checks import raise_on, stream

THREADS = 256       # csrc/adam_update.cu
UNROLL = 4          # 16-byte units of each operand a thread has in flight
TILE = THREADS * UNROLL
BLOCKS_PER_SM = 2   # the update's grid at most

Tensors = Sequence[torch.Tensor]
LR = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def adam_update_reference(params: Tensors, grads: Tensors, exp_avgs: Tensors,
                          exp_avg_sqs: Tensors, steps: Tensors, *, lr: LR,
                          betas: Tuple[float, float], eps: float,
                          weight_decay: float = 0.0) -> None:
    """The kernel's expression in PyTorch, tensor by tensor, in place. With
    an ``lr`` tensor on the card it reads nothing on the host, so a CUDA graph
    can capture it."""
    beta1, beta2 = betas
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=p.device)
        t = step + 1
        if weight_decay:
            p.mul_(1 - lr_t * weight_decay)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        step_size = ((torch.pow(beta1, t) - 1) / lr_t).reciprocal()
        bc2_sqrt = (1 - torch.pow(beta2, t)).sqrt()
        p.addcdiv_(m, (v.sqrt() / bc2_sqrt + eps) / step_size)
        step.add_(1)


# ---------------------------------------------------------------------------
# how the update splits a part (csrc/adam_update.cu)
# ---------------------------------------------------------------------------


def update_blocks(units: int, sms: int) -> int:
    """The update's grid: a block per tile, at most ``BLOCKS_PER_SM`` a SM
    (``vct_adam_plan``)."""
    return max(1, min(-(-units // TILE), sms * BLOCKS_PER_SM))


def block_tiles(units: int, blocks: int, block: int) -> List[Tuple[int, int]]:
    """The unit ranges ``block`` of ``blocks`` updates, in order: tiles
    ``block``, ``block + blocks``, ... of the part's ``units``."""
    return [(t * TILE, min((t + 1) * TILE, units))
            for t in range(block, -(-units // TILE), blocks)]


# ---------------------------------------------------------------------------
# checks and the CUDA launch
# ---------------------------------------------------------------------------


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr) -> torch.device:
    n = len(params)
    if n == 0 or not all(len(x) == n for x in (grads, exp_avgs, exp_avg_sqs, steps)):
        raise ValueError("adam_update: params, grads, exp_avgs, exp_avg_sqs and steps "
                         "must be non-empty lists of one length")
    dev = params[0].device
    f32 = torch.float32
    for i, p in enumerate(params):
        for name, t in (("param", p), ("grad", grads[i]), ("exp_avg", exp_avgs[i]),
                        ("exp_avg_sq", exp_avg_sqs[i])):
            _expect(t, f"{name} {i}", p.shape, f32, dev)
        _expect(steps[i], f"step {i}", (), f32, dev, vector_loads=False)
    if not isinstance(lr, torch.Tensor):
        raise TypeError("adam_update: on the card lr is a 0-dim float32 tensor on the "
                        "params' device (train.optimizers.settle_optimizer makes it)")
    _expect(lr, "lr", (), f32, dev, vector_loads=False)
    return dev


def _launch(params, grads, exp_avgs, exp_avg_sqs, steps, lr, betas, eps,
            weight_decay) -> int:
    """-> the launches made (one a part of at most the library's capacity)."""
    from vct_tpu_torch.ops._build import load_library

    dev = _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr)
    lib = load_library()
    cap = lib.vct_adam_capacity()
    beta1, beta2 = (float(b) for b in betas)
    lists = (params, grads, exp_avgs, exp_avg_sqs, steps)
    parts = range(0, len(params), cap)
    with torch.cuda.device(dev):
        for c0 in parts:
            k = len(params[c0:c0 + cap])
            ptrs = (ctypes.c_ulonglong * (5 * k))(
                *(t.data_ptr() for ts in lists for t in ts[c0:c0 + k]))
            numel = (ctypes.c_longlong * k)(*(p.numel() for p in params[c0:c0 + k]))
            err = lib.vct_adam_update(k, ptrs, numel, lr.data_ptr(), beta1, beta2,
                                      1 - beta1, 1 - beta2, float(eps), float(weight_decay),
                                      stream(dev))
            raise_on(err, "vct_adam_update")
    return len(parts)


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------


def adam_update(params: Tensors, grads: Tensors, exp_avgs: Tensors, exp_avg_sqs: Tensors,
                steps: Tensors, *, lr: LR, betas: Tuple[float, float], eps: float,
                weight_decay: float = 0.0) -> None:
    """One Adam step of each param in place (see the module's docstring)."""
    params = list(params)
    if not params or not _on_cuda(params[0], "adam_update"):
        adam_update_reference(params, grads, exp_avgs, exp_avg_sqs, steps, lr=lr,
                              betas=betas, eps=eps, weight_decay=weight_decay)
        return
    adam_update.launches += _launch(params, list(grads), list(exp_avgs), list(exp_avg_sqs),
                                    list(steps), lr, betas, eps, weight_decay)
    adam_update.elements += sum(p.numel() for p in params)


adam_update.launches = 0
adam_update.elements = 0
