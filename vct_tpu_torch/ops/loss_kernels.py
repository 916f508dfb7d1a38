"""The three fused LM-head + SCE loss kernels, each beside its plain PyTorch
version.

Port of ``vct_tpu/ops/pallas_loss.py``:

* ``softmax_stats`` (``pallas_loss.py:124``) — per row over ascending vocab
  tiles of the logits: online max ``m``, rescaled sum ``s``, label logit
  ``zt`` (``lse = m + log s``);
* ``clipped_prob_stats`` (``pallas_loss.py:207``) — given ``lse``: the sum
  ``sa`` and the count ``cnt`` of the softmax probabilities above 1e-7;
* ``sce_backward_tiles`` (``pallas_loss.py:305``) — ``dz = p * (u + c * a) -
  onehot * lab_term`` per tile, ``dx`` accumulated over tiles from the rounded
  ``dz``, the ``dz`` tiles in the compute dtype, and per-row-tile partial sums
  of the un-rounded ``dz`` for the bias gradient.

Layout (the port's own, not the reference's): ``x`` [N, E] in the compute
dtype; the generator weight ``w`` [V_pad, E] — PyTorch's own ``[out, in]``
layout, so the parameter is cast and padded but never transposed — and ``b``
[V_pad], both in the compute dtype, with V_pad a multiple of ``BLOCK_V`` whose
pad rows are zero and carry a ``NEG_INF`` bias (``pad_generator`` builds
them); ``labels`` [N] int32; every per-row vector [N] float32. Rows are not
padded: the kernels mask the ragged last row tile themselves.

The logits tile is the float32-accumulated product rounded to the compute
dtype with the bias added in that dtype; all statistics are float32.

Dispatch: a wrapper given CPU tensors runs the ``*_reference`` version; given
CUDA tensors it launches the CUDA kernel (``csrc/sce_loss.cu``) or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from vct_tpu_torch.ops._checks import expect as _expect
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda
from vct_tpu_torch.ops._checks import raise_on, stream

NEG_INF = -1e30
EPS = 1e-7
BLOCK_V = 512   # vocab tile: fixes the order of every float reduction
MAX_E = 1664    # widest row tile of x that fits a block's shared memory
ROW_TILE = {torch.bfloat16: 32, torch.float32: 16}  # Cfg<T>::BM in csrc/sce_loss.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_generator(wg: torch.Tensor, bg: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generator parameters (``wg`` [V, E], ``bg`` [V]) as the kernels take
    them: compute dtype, vocab padded to a multiple of ``BLOCK_V`` with zero
    rows and a ``NEG_INF`` bias, so a pad column's probability is exactly 0."""
    v, e = wg.shape
    v_pad = _round_up(v, BLOCK_V)
    w = torch.zeros((v_pad, e), dtype=dtype, device=wg.device)
    w[:v] = wg.detach()
    b = torch.full((v_pad,), NEG_INF, dtype=dtype, device=bg.device)
    b[:v] = bg.detach()
    return w, b


# ---------------------------------------------------------------------------
# plain PyTorch versions (same tile order and rounding points as the kernels)
# ---------------------------------------------------------------------------


def _tile_logits(x, w, b, start: int) -> torch.Tensor:
    """One vocab tile's logits -> [N, BLOCK_V] float32 holding compute-dtype
    values: float32 products and accumulation, rounded, bias added in dtype."""
    z32 = x.float() @ w[start:start + BLOCK_V].float().t()
    return (z32.to(x.dtype) + b[start:start + BLOCK_V]).float()


def softmax_stats_reference(x, w, b, labels):
    n = x.shape[0]
    dev = x.device
    m = torch.full((n,), float("-inf"), device=dev)
    s = torch.zeros((n,), device=dev)
    zt = torch.zeros((n,), device=dev)
    cols = torch.arange(BLOCK_V, device=dev)
    for start in range(0, w.shape[0], BLOCK_V):
        z = _tile_logits(x, w, b, start)
        m_new = torch.maximum(m, z.max(dim=-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(dim=-1)
        m = m_new
        hit = cols[None, :] == (labels - start)[:, None]
        zt = zt + torch.where(hit, z, 0.0).sum(dim=-1)
    return m, s, zt


def clipped_prob_stats_reference(x, w, b, lse):
    n = x.shape[0]
    sa = torch.zeros((n,), device=x.device)
    cnt = torch.zeros((n,), device=x.device)
    for start in range(0, w.shape[0], BLOCK_V):
        p = torch.exp(_tile_logits(x, w, b, start) - lse[:, None])
        above = p > EPS
        sa = sa + torch.where(above, p, 0.0).sum(dim=-1)
        cnt = cnt + above.float().sum(dim=-1)
    return sa, cnt


def sce_backward_tiles_reference(x, w, b, lse, u, cc, lab_term, labels):
    n, e = x.shape
    v_pad = w.shape[0]
    dev, dt = x.device, x.dtype
    tile = ROW_TILE[dt]
    n_tiles = (n + tile - 1) // tile
    dx = torch.zeros((n, e), device=dev)
    dz_out = torch.empty((n, v_pad), dtype=dt, device=dev)
    dbg_parts = torch.empty((n_tiles, v_pad), device=dev)
    cols = torch.arange(BLOCK_V, device=dev)
    for start in range(0, v_pad, BLOCK_V):
        p = torch.exp(_tile_logits(x, w, b, start) - lse[:, None])
        dz = p * (u[:, None] + cc[:, None] * (p > EPS).float())
        hit = cols[None, :] == (labels - start)[:, None]
        dz = dz - torch.where(hit, lab_term[:, None], 0.0)  # before the rounding
        dz_dt = dz.to(dt)
        dz_out[:, start:start + BLOCK_V] = dz_dt
        padded = F.pad(dz, (0, 0, 0, n_tiles * tile - n))
        dbg_parts[:, start:start + BLOCK_V] = padded.view(n_tiles, tile, BLOCK_V).sum(dim=1)
        dx = dx + dz_dt.float() @ w[start:start + BLOCK_V].float()
    return dx, dz_out, dbg_parts


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _check_common(x, w, b, rows):
    """Shapes and types shared by the three kernels -> (n, e, v_pad);
    ``rows`` maps a name to an [N] vector and its dtype."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; kernels take float32 or bfloat16")
    n, e = x.shape
    v_pad = w.shape[0]
    if e % 128 or e > MAX_E:
        raise ValueError(f"width {e} must be a multiple of 128 and at most {MAX_E} (the "
                         f"kernels keep a row tile of x in shared memory)")
    if v_pad % BLOCK_V:
        raise ValueError(f"padded vocab {v_pad} must be a multiple of {BLOCK_V}")
    if n < 1:
        raise ValueError("no rows")
    dev = x.device
    _expect(x, "x", (n, e), x.dtype, dev)
    _expect(w, "w", (v_pad, e), x.dtype, dev)
    _expect(b, "b", (v_pad,), x.dtype, dev)
    for name, (t, dtype) in rows.items():
        _expect(t, name, (n,), dtype, dev)
    return n, e, v_pad


def _launch(fn_name: str, x, *args):
    from vct_tpu_torch.ops._build import load_library

    lib = load_library()
    n, e = x.shape
    dev = x.device
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            _DTYPE_CODE[x.dtype], x.data_ptr(), *(t.data_ptr() for t in args[:-1]),
            n, e, args[-1], stream(dev))
    raise_on(err, fn_name)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def softmax_stats(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (m, s, zt), each [N] float32. A label outside [0, V_pad) gives
    ``zt`` = 0."""
    if not _on_cuda(x, "softmax_stats"):
        return softmax_stats_reference(x, w, b, labels)
    n, _, v_pad = _check_common(x, w, b, {"labels": (labels, torch.int32)})
    m, s, zt = (torch.empty((n,), dtype=torch.float32, device=x.device) for _ in range(3))
    _launch("vct_sce_softmax_stats", x, w, b, labels, m, s, zt, v_pad)
    softmax_stats.launches += 1
    return m, s, zt


def clipped_prob_stats(x, w, b, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sa, cnt), each [N] float32. Pad columns never count as above; the
    caller adds the floor of the below-set with the true vocab size."""
    if not _on_cuda(x, "clipped_prob_stats"):
        return clipped_prob_stats_reference(x, w, b, lse)
    n, _, v_pad = _check_common(x, w, b, {"lse": (lse, torch.float32)})
    sa, cnt = (torch.empty((n,), dtype=torch.float32, device=x.device) for _ in range(2))
    _launch("vct_sce_clipped_stats", x, w, b, lse, sa, cnt, v_pad)
    clipped_prob_stats.launches += 1
    return sa, cnt


def sce_backward_tiles(x, w, b, lse, u, cc, lab_term, labels
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dx [N, E] float32, dz [N, V_pad] compute dtype, dbg_parts
    [ceil(N / ROW_TILE), V_pad] float32). A width above 768 is served in
    column slabs of ``dx``, each with its own walk over the vocab.
    ``dwg = dz^T @ x`` is left to one
    matrix product outside the kernel, as in the reference, and
    ``dbg = dbg_parts.sum(0)``."""
    if not _on_cuda(x, "sce_backward_tiles"):
        return sce_backward_tiles_reference(x, w, b, lse, u, cc, lab_term, labels)
    f32 = torch.float32
    n, e, v_pad = _check_common(x, w, b, {
        "lse": (lse, f32), "u": (u, f32), "cc": (cc, f32), "lab_term": (lab_term, f32),
        "labels": (labels, torch.int32)})
    tile = ROW_TILE[x.dtype]
    dev = x.device
    dx = torch.empty((n, e), dtype=f32, device=dev)
    dz = torch.empty((n, v_pad), dtype=x.dtype, device=dev)
    dbg_parts = torch.empty(((n + tile - 1) // tile, v_pad), dtype=f32, device=dev)
    _launch("vct_sce_backward", x, w, b, lse, u, cc, lab_term, labels, dx, dz, dbg_parts,
            v_pad)
    sce_backward_tiles.launches += 1
    return dx, dz, dbg_parts


softmax_stats.launches = 0
clipped_prob_stats.launches = 0
sce_backward_tiles.launches = 0
WRAPPERS = (softmax_stats, clipped_prob_stats, sce_backward_tiles)
