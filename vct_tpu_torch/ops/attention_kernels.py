"""The two fused attention kernels, each beside its plain PyTorch version.

Port of ``vct_tpu/ops/pallas_attention.py``:

* ``fused_attention`` (``pallas_attention.py:81``) — inference:
  ``softmax(q k^T / sqrt(D) + bias) v``;
* ``fused_attention_trainable`` (``pallas_attention.py:271``; forward
  ``_train_fwd`` :288, backward ``_train_bwd`` :314) — the same forward with a
  caller-drawn keep mask on the weights (kept weights scaled by
  ``1 / (1 - rate)``), differentiable in q, k and v through a backward that
  recomputes the weights: ``dV = Pd^T dO``, ``dP = keep(dO V^T) / (1 - rate)``,
  ``dS = P * (dP - rowsum(P * dP)) * scale``, ``dQ = dS K``, ``dK = dS^T Q``.
  GRADIENT CONTRACT, as in the reference: the bias gets no gradient (every
  bias this framework builds is a mask constant) and neither does the mask.

Layout: q [B, Tq, H, D], k and v [B, Tk, H, D], float32 or bfloat16, D a
multiple of 16 up to 128, any Tq, Tk >= 1; bias float32 broadcastable to
[B, H, Tq, Tk] or None; keep bool [B, H, Tq, Tk] or None. Nothing is padded,
transposed or materialised for the kernels: q/k/v are read by their strides
(the slices of a packed QKV projection go in as they are) and the bias by its
broadcast strides.

Rounding points (``pallas_attention.py:51-68``, ``:184-244``): float32 logits
from compute-dtype q and k, times ``rsqrt(D)``, plus the bias; float32 max,
exp, sum, ``e / s``; the keep mask; the weights rounded to v's dtype before
P.V; float32 accumulation; the output rounded to q's dtype. In the backward
P, dP and dS stay float32 in the plain version; the bfloat16 CUDA kernel
rounds P, the dropped P and dS to bfloat16 for the tensor cores (float32
accumulation), the float32 kernel rounds nothing.

What bounds the kernels on an H100: bytes (q, k, v, o, the bias, the 1-byte
mask) against 4 * Tq * Tk * D operations per (batch, head) cell forward; see
``csrc/attention.cu`` for the design. The forward has two routes
(``attention_forward_plan``): bfloat16 keeps a query tile's logits on chip and
computes Q.K^T once while they fit a block's shared memory; float32, and
bfloat16 past that limit, run two passes over the key tiles. So has the
backward (``attention_backward_plan``): bfloat16 keeps a query tile's P and dP
on chip and its products in registers while they fit; float32, and bfloat16
past that limit, run the pair of kernels with shared-memory accumulators.

Dispatch: a wrapper given CPU tensors runs the ``*_reference`` version; given
CUDA tensors it launches the CUDA kernel (``csrc/attention.cu``) or raises.
``fused_attention.launches`` counts its launches,
``fused_attention_trainable.launches`` the trainable forward's and
``fused_attention_trainable.backward_launches`` the backward's.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from vct_tpu_torch.ops._checks import SMEM_LIMIT, raise_on, stream
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda

NEG_INF = -1e30
MAX_D = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernel bodies' math, step by step)
# ---------------------------------------------------------------------------


def _scale(q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def _probabilities(q, k, bias) -> torch.Tensor:
    """float32 softmax weights [B, H, Tq, Tk]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(q)
    if bias is not None:
        logits = logits + bias.float()
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def _keep_scaled(x, keep, rate: float):
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


def fused_attention_trainable_reference(q, k, v, bias=None, keep=None, rate: float = 0.0):
    """The forward -> out [B, Tq, H, D] in q's dtype."""
    pd = _keep_scaled(_probabilities(q, k, bias), keep, rate)
    out = torch.einsum("bhqk,bkhd->bqhd", pd.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def fused_attention_reference(q, k, v, bias=None):
    return fused_attention_trainable_reference(q, k, v, bias)


def fused_attention_backward_reference(q, k, v, bias, keep, rate: float, g
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recompute backward -> (dq, dk, dv) in the inputs' dtypes."""
    p = _probabilities(q, k, bias)
    pd = _keep_scaled(p, keep, rate)
    do = g.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, do)
    dp = _keep_scaled(torch.einsum("bqhd,bkhd->bhqk", do, v.float()), keep, rate)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * _scale(q)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _check(q, k, v, bias, keep, rate: float):
    """Raises on what the kernels do not take -> (B, H, Tq, Tk, D)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q has dtype {q.dtype}; the kernels take float32 or bfloat16")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"[B, Tq, H, D] and two [B, Tk, H, D]")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q {q.dtype} on {q.device}")
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"head width {d} must be a multiple of 16 from 16 to {MAX_D}")
    if tq < 1 or tk < 1 or b < 1 or b > 65535 or h > 65535:
        raise ValueError(f"no kernel for B={b}, H={h}, Tq={tq}, Tk={tk}")
    if bias is not None:
        if bias.ndim > 4 or bias.device != q.device:
            raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}")
        if torch.broadcast_shapes(bias.shape, (b, h, tq, tk)) != (b, h, tq, tk):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                             f"{(b, h, tq, tk)}")
    if (keep is None) != (rate <= 0.0):
        raise ValueError("a keep mask is required exactly when the dropout rate is above 0")
    if keep is not None:
        if keep.dtype != torch.bool or tuple(keep.shape) != (b, h, tq, tk) \
                or keep.device != q.device:
            raise ValueError(f"keep must be bool {(b, h, tq, tk)} on {q.device}, got "
                             f"{keep.dtype} {tuple(keep.shape)} on {keep.device}")
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout rate {rate} outside (0, 1)")
    return b, h, tq, tk, d


class ForwardPlan(NamedTuple):
    """How ``csrc/attention.cu`` launches a forward, field for field what
    ``vct_attn_forward_plan`` reports. ``route`` 1 keeps the float32 logits of
    a query tile in shared memory and computes Q.K^T once; ``route`` 0 is the
    two-pass kernel."""
    route: int
    tile_q: int
    tile_k: int
    stages: int
    smem_bytes: int
    threads: int


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _onchip_bytes(tk: int, d: int, has_keep: bool) -> int:
    """64 rows of Tk float32 logits (Tk rounded up to whole 64-key tiles), two
    ring stages of 64 x (d + 8) bfloat16 and, with a keep mask, two 64 x 80
    byte tiles."""
    return 64 * -(-tk // 64) * 64 * 4 + 2 * (64 * (d + 8) * 2 + (64 * 80 if has_keep else 0))


def attention_forward_plan(tk: int, d: int, dtype, has_keep: bool, route: int = -1
                           ) -> ForwardPlan:
    """The launch plan of the forward for Tk keys of width ``d``, as the C
    launcher forms it: a description for tests and readers, not on the launch
    path. The shape rule (``route`` -1): bfloat16 takes the on-chip route
    while its shared memory fits ``SMEM_LIMIT`` (Tk up to 768 at d = 96, 704
    with a keep mask); float32, and bfloat16 past that, take the two-pass
    route. 0 or 1 asks for that route; 1 raises where it does not fit."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}; the kernels take float32 or bfloat16")
    if tk < 1 or d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"no kernel for Tk={tk}, head width {d}")
    fits = dtype == torch.bfloat16 and _onchip_bytes(tk, d, has_keep) <= SMEM_LIMIT
    if route not in (-1, 0, 1) or (route == 1 and not fits):
        raise ValueError(f"route {route} for Tk={tk}, d={d}, {dtype}")
    if route == 1 or (route < 0 and fits):
        return ForwardPlan(1, 64, 64, 2, _onchip_bytes(tk, d, has_keep), 256)
    tile, pad, size = (64, 8, 2) if dtype == torch.bfloat16 else (32, 4, 4)
    smem = (2 * _round128(tile * (d + pad) * size) + _round128(tile * (tile + 4) * 4)
            + _round128(tile * (tile + pad) * size) + _round128(tile * (d + 4) * 4))
    return ForwardPlan(0, tile, tile, 1, smem, 256)


class BackwardPlan(NamedTuple):
    """How ``csrc/attention.cu`` launches a backward, field for field what
    ``vct_attn_backward_plan`` reports. ``route`` 1: kernel 1 takes
    ``tile_q`` query rows a block (P and dP on chip, dQ and delta), kernel 2
    ``tile_k`` keys a block (dK, dV), products in registers; ``route`` 0: the
    pair with shared-memory accumulators."""
    route: int
    tile_q: int
    tile_k: int
    stages: int
    smem_dq: int
    smem_dkv: int
    threads: int


def _onchip_bwd_bytes(tk: int, d: int, has_keep: bool) -> Tuple[int, int]:
    """Kernel 1: 64 rows of P and dP over Tk (whole 64-key tiles), float32,
    and two ring stages of two 64 x (d + 8) bfloat16 tiles plus, with a keep
    mask, 64 x 80 keep bytes. Kernel 2: the K and V tiles and two
    stages of the Q and dO tiles, 768 bytes of row statistics and 64 x 80 keep
    bytes."""
    tile = 64 * (d + 8) * 2
    dq = 64 * -(-tk // 64) * 64 * 8 + 2 * (2 * tile + (64 * 80 if has_keep else 0))
    dkv = 2 * tile + 2 * (2 * tile + 768 + (64 * 80 if has_keep else 0))
    return dq, dkv


def attention_backward_plan(tk: int, d: int, dtype, has_keep: bool, route: int = -1
                            ) -> BackwardPlan:
    """The launch plan of the backward for Tk keys of width ``d``, as the C
    launcher forms it: a description for tests and readers, not on the launch
    path. The shape rule (``route`` -1): bfloat16 takes the on-chip route with
    64-row query tiles while kernel 1 fits ``SMEM_LIMIT`` (Tk up to 320 at
    d = 96); float32, and bfloat16 past that, take the pair with
    shared-memory accumulators. 0 or 1 asks for that route; 1 raises where it
    does not fit."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}; the kernels take float32 or bfloat16")
    if tk < 1 or d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"no kernel for Tk={tk}, head width {d}")
    dq, dkv = _onchip_bwd_bytes(tk, d, has_keep)
    fits = dtype == torch.bfloat16 and max(dq, dkv) <= SMEM_LIMIT
    if route not in (-1, 0, 1) or (route == 1 and not fits):
        raise ValueError(f"route {route} for Tk={tk}, d={d}, {dtype}")
    if route == 1 or (route < 0 and fits):
        return BackwardPlan(1, 64, 64, 2, dq, dkv, 256)
    tile, pad, size = (64, 8, 2) if dtype == torch.bfloat16 else (32, 4, 4)
    data, acc = _round128(tile * (d + pad) * size), _round128(tile * (d + 4) * 4)
    s, pt = _round128(tile * (tile + 4) * 4), _round128(tile * (tile + pad) * size)
    return BackwardPlan(0, tile, tile, 1, 4 * data + 2 * s + pt + acc,
                        4 * data + 2 * s + 2 * pt + 2 * acc, 256)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels can read it: unit stride on D, every other stride
    and the start on a 16-byte boundary, offsets within 31 bits; else a
    contiguous copy."""
    per = 16 // t.element_size()
    span = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    ok = (t.stride(3) == 1 and all(s >= 0 and s % per == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0 and span < 2 ** 31)
    if ok:
        return t
    t = t.contiguous()
    if t.numel() >= 2 ** 31:
        raise ValueError("tensor too large for the kernels' 31-bit offsets")
    return t


def _bias_args(bias, shape):
    """-> (tensor kept alive, pointer or None, four broadcast strides)."""
    if bias is None:
        return None, None, [0, 0, 0, 0]
    bias = bias.to(torch.float32)
    view = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape)).expand(shape)
    if max(n * s for n, s in zip(view.shape, view.stride())) >= 2 ** 31:
        raise ValueError("bias too large for the kernels' 31-bit offsets")
    return view, view.data_ptr(), list(view.stride())


def _strides(*tensors) -> list:
    """(batch, time, head) element strides of each [B, T, H, D] tensor."""
    out = []
    for t in tensors:
        out += [0, 0, 0] if t is None else [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _launch_forward(q, k, v, bias, keep, rate: float, want_stats: bool, _route: int = -1):
    """``_route`` -1 leaves the choice to the launcher's rule on the shape, as
    every caller in the package does; only checks set it, to time or test one
    route (0 two passes, 1 logits on chip) where the rule takes the other."""
    from vct_tpu_torch.ops._build import load_library

    b, h, tq, tk, d = _check(q, k, v, bias, keep, rate)
    q, k, v = _strided(q), _strided(k), _strided(v)
    bias_view, bias_ptr, bias_strides = _bias_args(bias, (b, h, tq, tk))
    keep = None if keep is None else keep.contiguous()
    dev = q.device
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev)
    stats = torch.empty((b, h, tq, 2), dtype=torch.float32, device=dev) if want_stats else None
    strides = (ctypes.c_int * 16)(*(_strides(q, k, v, None) + bias_strides))
    with torch.cuda.device(dev):
        err = load_library().vct_attn_forward(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            None if keep is None else keep.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), b, h, tq, tk, d, strides,
            _scale(q), 1.0 - rate, _route, stream(dev))
    raise_on(err, "vct_attn_forward")
    del bias_view
    return out, stats


def _launch_backward(q, k, v, bias, keep, rate: float, g, stats, _route: int = -1):
    """``_route`` -1 leaves the choice to the launcher's rule on the shape, as
    every caller in the package does; only checks set it, to time or test one
    route (0 shared-memory accumulators, 1 products in registers) where the
    rule takes the other."""
    from vct_tpu_torch.ops._build import load_library

    b, h, tq, tk, d = _check(q, k, v, bias, keep, rate)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"dO {tuple(g.shape)} {g.dtype}, expected {tuple(q.shape)} {q.dtype}")
    q, k, v, g = _strided(q), _strided(k), _strided(v), _strided(g)
    bias_view, bias_ptr, bias_strides = _bias_args(bias, (b, h, tq, tk))
    keep = None if keep is None else keep.contiguous()
    dev = q.device
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, tk, h, d), dtype=q.dtype, device=dev)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int * 16)(*(_strides(q, k, v, g) + bias_strides))
    with torch.cuda.device(dev):
        err = load_library().vct_attn_backward(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            None if keep is None else keep.data_ptr(), g.data_ptr(), stats.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, d,
            strides, _scale(q), 1.0 - rate, _route, stream(dev))
    raise_on(err, "vct_attn_backward")
    del bias_view
    return dq, dk, dv


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def fused_attention(q, k, v, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference attention -> [B, Tq, H, D] in q's dtype; not differentiable."""
    q, k, v = q.detach(), k.detach(), v.detach()
    bias = None if bias is None else bias.detach()
    if not _on_cuda(q, "fused_attention"):
        _check(q, k, v, bias, None, 0.0)
        return fused_attention_reference(q, k, v, bias)
    out, _ = _launch_forward(q, k, v, bias, None, 0.0, False)
    fused_attention.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, keep, rate):
        ctx.rate = rate
        if _on_cuda(q, "fused_attention_trainable"):
            out, stats = _launch_forward(q, k, v, bias, keep, rate, True)
            fused_attention_trainable.launches += 1
        else:
            out, stats = fused_attention_trainable_reference(q, k, v, bias, keep, rate), None
        ctx.save_for_backward(q, k, v, bias, keep, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, keep, stats = ctx.saved_tensors
        if _on_cuda(q, "fused_attention_trainable"):
            grads = _launch_backward(q, k, v, bias, keep, ctx.rate, g, stats)
            fused_attention_trainable.backward_launches += 1
        else:
            grads = fused_attention_backward_reference(q, k, v, bias, keep, ctx.rate, g)
        return (*grads, None, None, None)


def fused_attention_trainable(q, k, v, bias: Optional[torch.Tensor] = None,
                              keep: Optional[torch.Tensor] = None,
                              rate: float = 0.0) -> torch.Tensor:
    """Differentiable attention with weight dropout -> [B, Tq, H, D]. ``keep``
    (bool [B, H, Tq, Tk], True = kept) is required exactly when ``rate`` > 0.
    The bias gets no gradient: pass mask constants only."""
    if bias is not None:
        bias = bias.detach()
    if not q.is_cuda:
        _check(q, k, v, bias, keep, float(rate))
    return _FusedAttention.apply(q, k, v, bias, keep, float(rate))


fused_attention.launches = 0
fused_attention_trainable.launches = 0
fused_attention_trainable.backward_launches = 0
