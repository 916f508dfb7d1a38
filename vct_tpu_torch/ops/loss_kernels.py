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
dtype; the generator weight ``w`` [V, E] — PyTorch's own ``[out, in]``
layout, so the parameter is cast but never transposed or padded — and ``b``
[V], both in the compute dtype; ``labels`` [N] int32; every per-row vector
[N] float32. V is any count of rows: the kernels and the plain versions mask
the ragged last vocab tile themselves (weight rows past V read as zeros, bias
entries past V as ``NEG_INF``), so a generator padded by ``pad_generator``
gives the same results as the bare one. ``dz`` and the ``dbg`` partials have
``round_up(V, BLOCK_V)`` columns. A label outside [0, V) has no logit (``zt``
0, no label term in ``dz``). Rows are not padded: the kernels mask the ragged
last row tile themselves.

The logits tile is the float32-accumulated product rounded to the compute
dtype with the bias added in that dtype; all statistics are float32.

Dispatch: a wrapper given CPU tensors runs the ``*_reference`` version; given
CUDA tensors it launches the CUDA kernel (``csrc/sce_loss.cu``) or raises.
Each wrapper counts its calls that launch in ``<wrapper>.launches``. In
bfloat16 the two statistics wrappers launch the tensor-core kernel, which
splits the vocab across blocks in slabs of ``SLAB_V`` columns and merges the
slabs' partials in a second, small kernel; ``sce_stats_plan`` describes how
the C launcher lays a call out. The bfloat16 backward launches two
tensor-core kernels (``dz`` and the ``dbg`` partials over the same slabs,
then ``dx`` with the vocab split into groups) and, with more than one group,
a merge of the groups' ``dx`` partials; ``sce_backward_plan`` describes it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vct_tpu_torch.ops._checks import SMEM_LIMIT
from vct_tpu_torch.ops._checks import expect as _expect
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda
from vct_tpu_torch.ops._checks import raise_on, stream

NEG_INF = -1e30
EPS = 1e-7
BLOCK_V = 512   # vocab tile of the plain versions and the backward: fixes the order of its sums
SLAB_V = 256    # vocab columns of a slab of the tensor-core statistics kernel (ST_BN)
MAX_E = 1664    # widest row tile of x that fits a block's shared memory (backward, float32)
# bfloat16: the tensor-core kernels stream x through their ring, so the row
# tile sets no limit there; the widest measured on the card (the LFM2 caption
# LM). The replaced row-tile kernels (``_route=0``, and the backward past
# ``BWD_MAX_N`` rows) refuse what does not fit their shared memory.
MAX_E_BF16 = 2048
ROW_TILE = {torch.bfloat16: 32, torch.float32: 16}  # Cfg<T>::BM in csrc/sce_loss.cu
H100_SMS = 132
BWD_MAX_N = 16384  # rows of the tensor-core backward's plan (BWD_MAX_N in csrc/sce_loss.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_generator(wg: torch.Tensor, bg: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generator parameters (``wg`` [V, E], ``bg`` [V]) in the compute
    dtype with the vocab padded to a multiple of ``BLOCK_V`` by zero rows and
    a ``NEG_INF`` bias, so a pad column's probability is exactly 0. The
    kernels no longer need it (they mask the ragged last tile); the tests use
    it to show that both forms give the same results."""
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


def _tile(w, b, start: int):
    """Rows [start, start + BLOCK_V) of the generator as the kernels load
    them: a short last tile is filled up with zero rows and a ``NEG_INF``
    bias."""
    wt, bt = w[start:start + BLOCK_V], b[start:start + BLOCK_V]
    short = BLOCK_V - wt.shape[0]
    if short:
        wt = F.pad(wt, (0, 0, 0, short))
        bt = F.pad(bt, (0, short), value=NEG_INF)
    return wt, bt


def _tile_logits(x, w, b, start: int) -> torch.Tensor:
    """One vocab tile's logits -> [N, BLOCK_V] float32 holding compute-dtype
    values: float32 products and accumulation, rounded, bias added in dtype."""
    wt, bt = _tile(w, b, start)
    z32 = x.float() @ wt.float().t()
    return (z32.to(x.dtype) + bt).float()


def _valid_labels(labels, v: int):
    """Labels outside [0, V) become -1, which no column matches."""
    return torch.where((labels >= 0) & (labels < v), labels, -1)


def softmax_stats_reference(x, w, b, labels):
    n = x.shape[0]
    dev = x.device
    m = torch.full((n,), float("-inf"), device=dev)
    s = torch.zeros((n,), device=dev)
    zt = torch.zeros((n,), device=dev)
    cols = torch.arange(BLOCK_V, device=dev)
    labels = _valid_labels(labels, w.shape[0])
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
    v_pad = _round_up(w.shape[0], BLOCK_V)
    dev, dt = x.device, x.dtype
    tile = ROW_TILE[dt]
    n_tiles = (n + tile - 1) // tile
    dx = torch.zeros((n, e), device=dev)
    dz_out = torch.empty((n, v_pad), dtype=dt, device=dev)
    dbg_parts = torch.empty((n_tiles, v_pad), device=dev)
    cols = torch.arange(BLOCK_V, device=dev)
    labels = _valid_labels(labels, w.shape[0])
    for start in range(0, v_pad, BLOCK_V):
        p = torch.exp(_tile_logits(x, w, b, start) - lse[:, None])
        dz = p * (u[:, None] + cc[:, None] * (p > EPS).float())
        hit = cols[None, :] == (labels - start)[:, None]
        dz = dz - torch.where(hit, lab_term[:, None], 0.0)  # before the rounding
        dz_dt = dz.to(dt)
        dz_out[:, start:start + BLOCK_V] = dz_dt
        padded = F.pad(dz, (0, 0, 0, n_tiles * tile - n))
        dbg_parts[:, start:start + BLOCK_V] = padded.view(n_tiles, tile, BLOCK_V).sum(dim=1)
        dx = dx + dz_dt.float() @ _tile(w, b, start)[0].float()
    return dx, dz_out, dbg_parts


# ---------------------------------------------------------------------------
# the launch plan of the two statistics kernels
# ---------------------------------------------------------------------------


class StatsPlan(NamedTuple):
    """How ``csrc/sce_loss.cu`` launches ``softmax_stats`` or
    ``clipped_prob_stats``, field for field what ``vct_sce_stats_plan``
    reports. ``route`` 1 is the tensor-core kernel (bfloat16): tiles of
    ``rows`` x ``cols`` (a row tile against a vocab slab), K in steps of
    ``kstep`` through ``stages`` ring stages, ``row_tiles`` x ``slabs`` tiles
    over ``grid`` persistent blocks. ``route`` 0 is ``stats_kernel``: one
    block of ``rows`` rows per row tile walks the vocab in tiles of ``cols``
    (``slabs`` 1, ``grid`` = ``row_tiles``)."""
    route: int
    rows: int
    cols: int
    kstep: int
    stages: int
    smem_bytes: int
    row_tiles: int
    slabs: int
    grid: int


def _stats_kernel_smem(e: int, dtype) -> int:
    """``smem_bytes<T>(e, false)``: x's row tile, the logits tile, two
    weight stages, eight warps' fragment patches and the per-row scalars."""
    rows, kc, pad, size = (32, 32, 8, 2) if dtype == torch.bfloat16 else (16, 16, 4, 4)
    return (rows * (e + pad) * size + rows * (BLOCK_V + pad) * size
            + 2 * BLOCK_V * (kc + pad) * size + 8 * 256 * 4 + 5 * rows * 4)


def sce_stats_plan(n: int, e: int, v: int, dtype, route: int = -1,
                   sms: int = H100_SMS) -> StatsPlan:
    """The launch plan of the statistics kernels for x [n, e] against a
    generator of ``v`` rows, on a card of ``sms`` SMs, as the C launcher
    forms it: a description for tests and readers, not on the launch path.
    The rule (``route`` -1): bfloat16 takes the tensor-core kernel at every
    width the wrappers admit (it streams x through its ring as it streams the
    weight, so no width is too wide for it); float32 takes ``stats_kernel``.
    0 or 1 asks for that route. Raises on what the kernels do not take."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}; kernels take float32 or bfloat16")
    if n < 1 or e < 128 or e % 128 or v < 1 or sms < 1:
        raise ValueError(f"N={n}, width {e}, vocab {v}: N >= 1, a width that is a multiple "
                         f"of 128, a vocab >= 1")
    if route not in (-1, 0, 1) or (route == 1 and dtype != torch.bfloat16):
        raise ValueError(f"route {route} for {dtype}")
    if route < 0:
        route = 1 if dtype == torch.bfloat16 else 0
    if route == 1:
        rows, cols, kstep, stages = 128, SLAB_V, 64, 4
        # 1 KB to reach a 1024-byte boundary; per stage the x rows and the
        # weight rows of one K step, 128 swizzled bytes each; two slabs of bias
        smem = 1024 + stages * (rows + cols) * 128 + 2 * cols * 2
        row_tiles, slabs = -(-n // rows), -(-v // cols)
        plan = StatsPlan(1, rows, cols, kstep, stages, smem, row_tiles, slabs,
                         min(row_tiles * slabs, sms))
    else:
        rows = ROW_TILE[dtype]
        plan = StatsPlan(0, rows, BLOCK_V, 32 if dtype == torch.bfloat16 else 16, 2,
                         _stats_kernel_smem(e, dtype), -(-n // rows), 1, -(-n // rows))
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"width {e} needs {plan.smem_bytes} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return plan


class BwdPlan(NamedTuple):
    """How ``csrc/sce_loss.cu`` launches ``sce_backward_tiles``, field for
    field what ``vct_sce_backward_plan`` reports. ``route`` 1 (bfloat16) is
    the tensor-core pair: ``bwd_dz_wgmma_kernel`` over ``row_tiles`` x
    ``slabs`` tiles of ``rows`` x ``cols`` on ``grid`` persistent blocks (K
    in steps of ``kstep`` through ``stages`` ring stages, ``smem_bytes``),
    then ``bwd_dx_wgmma_kernel``, one block of ``dx_smem_bytes`` per unit of
    (vocab group, 128-row tile, 256-column E tile): ``e_tiles`` x row tiles x
    ``groups`` = ``dx_units``, with the groups' partials merged when
    ``groups`` > 1. ``route`` 0 is ``backward_kernel``: one block per row
    tile of ``rows`` walks the vocab in tiles of ``cols``, once per
    ``e_tiles`` column slab of dx."""
    route: int
    rows: int
    cols: int
    kstep: int
    stages: int
    smem_bytes: int
    row_tiles: int
    slabs: int
    grid: int
    e_tiles: int
    groups: int
    dx_units: int
    dx_smem_bytes: int


def dx_groups(tiles: int, ksteps: int, sms: int) -> int:
    """The vocab groups of the tensor-core ``dx`` (``dx_groups`` in
    csrc/sce_loss.cu): the first count in [1, min(16, ksteps // 8)] whose
    ``tiles`` x count units fill at least 90% of their last wave over
    ``sms`` SMs, else the count that fills the most (the smallest on a
    tie)."""
    cap = max(1, min(16, ksteps // 8))
    best, best_fill = 1, -1
    for groups in range(1, cap + 1):
        units = tiles * groups
        fill = units * 1000000 // (-(-units // sms) * sms)
        if fill >= 900000:
            return groups
        if fill > best_fill:
            best, best_fill = groups, fill
    return best


def _backward_kernel_smem(e: int, dtype) -> int:
    """``smem_bytes<T>(e, true)``: as the statistics kernel's, with a weight
    stage wide enough for a dx column slab of up to 768."""
    rows, kc, kc2, pad, size = (32, 32, 16, 8, 2) if dtype == torch.bfloat16 \
        else (16, 16, 8, 4, 4)
    stage = max(BLOCK_V * (kc + pad), kc2 * (min(e, 768) + pad))
    return (rows * (e + pad) * size + rows * (BLOCK_V + pad) * size + 2 * stage * size
            + 8 * 256 * 4 + 5 * rows * 4)


def sce_backward_plan(n: int, e: int, v: int, dtype, route: int = -1,
                      sms: int = H100_SMS) -> BwdPlan:
    """The launch plan of ``sce_backward_tiles`` for x [n, e] against a
    generator of ``v`` rows on a card of ``sms`` SMs, as the C launcher forms
    it (a description for tests and readers, not on the launch path). The
    rule (``route`` -1): bfloat16 with 1 <= n <= ``BWD_MAX_N`` takes the
    tensor-core pair (the ``dx`` partials of its vocab groups are sized by
    n); float32, and bfloat16 past that, take ``backward_kernel``. 0 or 1
    asks for that route. Raises on what the kernels do not take."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}; kernels take float32 or bfloat16")
    if n < 1 or e < 128 or e % 128 or v < 1 or sms < 1:
        raise ValueError(f"N={n}, width {e}, vocab {v}: N >= 1, a width that is a multiple "
                         f"of 128, a vocab >= 1")
    if route not in (-1, 0, 1) or (route == 1 and (dtype != torch.bfloat16 or n > BWD_MAX_N)):
        raise ValueError(f"route {route} for {dtype} at N={n}")
    if route < 0:
        route = 1 if dtype == torch.bfloat16 and n <= BWD_MAX_N else 0
    v_pad = _round_up(v, BLOCK_V)
    if route == 1:
        rows, cols, kstep, stages = 128, SLAB_V, 64, 4
        # the statistics kernel's ring and bias, two tiles' per-row values,
        # the odd warps' dbg sums
        smem = 1024 + stages * (rows + cols) * 128 + 2 * cols * 2 + 2 * 5 * rows * 4 + 4 * cols * 4
        row_tiles, slabs = -(-n // rows), v_pad // cols
        e_tiles = -(-e // 256)
        dx_tiles = -(-n // 128) * e_tiles
        groups = dx_groups(dx_tiles, v_pad // 64, sms)
        # per stage: 128 dz rows of 128 swizzled bytes, 64 weight rows at a
        # pitch of 264 elements
        dx_smem = 1024 + 4 * (128 * 128 + 64 * 264 * 2)
        plan = BwdPlan(1, rows, cols, kstep, stages, smem, row_tiles, slabs,
                       min(row_tiles * slabs, sms), e_tiles, groups, dx_tiles * groups, dx_smem)
    else:
        rows = ROW_TILE[dtype]
        plan = BwdPlan(0, rows, BLOCK_V, 32 if dtype == torch.bfloat16 else 16, 2,
                       _backward_kernel_smem(e, dtype), -(-n // rows), 1, -(-n // rows),
                       -(-e // 768), 1, 0, 0)
    if max(plan.smem_bytes, plan.dx_smem_bytes) > SMEM_LIMIT:
        raise ValueError(f"width {e} needs {plan.smem_bytes} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return plan


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _check_common(x, w, b, rows):
    """Shapes and types shared by the three kernels -> (n, e, v);
    ``rows`` maps a name to an [N] vector and its dtype."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; kernels take float32 or bfloat16")
    n, e = x.shape
    v = w.shape[0]
    cap = MAX_E_BF16 if x.dtype == torch.bfloat16 else MAX_E
    if e % 128 or e > cap:
        raise ValueError(f"width {e} must be a multiple of 128 and at most {cap} in {x.dtype} "
                         f"(float32's kernels keep a row tile of x in shared memory)")
    if n < 1 or v < 1:
        raise ValueError(f"no rows (N={n}, vocab {v})")
    dev = x.device
    _expect(x, "x", (n, e), x.dtype, dev)
    _expect(w, "w", (v, e), x.dtype, dev)
    _expect(b, "b", (v,), x.dtype, dev)
    for name, (t, dtype) in rows.items():
        _expect(t, name, (n,), dtype, dev)
    return n, e, v


def _launch(fn_name: str, x, tensors, ints):
    """``fn_name``(dtype, x, *tensors, n, e, *ints, stream); a tensor may be
    None (a null pointer)."""
    from vct_tpu_torch.ops._build import load_library

    lib = load_library()
    n, e = x.shape
    dev = x.device
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            _DTYPE_CODE[x.dtype], x.data_ptr(),
            *(None if t is None else t.data_ptr() for t in tensors), n, e, *ints, stream(dev))
    raise_on(err, fn_name)


def _stats_scratch(x, v: int, route: int) -> Optional[torch.Tensor]:
    """The slab partials of the tensor-core kernel, float32 [2, slabs, N];
    None where ``stats_kernel`` runs (float32, or route 0)."""
    if x.dtype != torch.bfloat16 or route == 0:
        return None
    return torch.empty((2, -(-v // SLAB_V), x.shape[0]), dtype=torch.float32, device=x.device)


def _launch_softmax_stats(x, w, b, labels, _route: int = -1):
    """``_route`` -1 leaves the choice to the launcher's rule, as every
    caller in the package does; only checks set it, to time or test
    ``stats_kernel`` (0) on bfloat16 inputs."""
    n, _, v = _check_common(x, w, b, {"labels": (labels, torch.int32)})
    m, s, zt = (torch.empty((n,), dtype=torch.float32, device=x.device) for _ in range(3))
    _launch("vct_sce_softmax_stats", x, (w, b, labels, m, s, zt, _stats_scratch(x, v, _route)),
            (v, _route))
    return m, s, zt


def _launch_clipped_prob_stats(x, w, b, lse, _route: int = -1):
    """``_route`` as in ``_launch_softmax_stats``."""
    n, _, v = _check_common(x, w, b, {"lse": (lse, torch.float32)})
    sa, cnt = (torch.empty((n,), dtype=torch.float32, device=x.device) for _ in range(2))
    _launch("vct_sce_clipped_stats", x, (w, b, lse, sa, cnt, _stats_scratch(x, v, _route)),
            (v, _route))
    return sa, cnt


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def softmax_stats(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (m, s, zt), each [N] float32. A label outside [0, V) gives
    ``zt`` = 0."""
    if not _on_cuda(x, "softmax_stats"):
        return softmax_stats_reference(x, w, b, labels)
    out = _launch_softmax_stats(x, w, b, labels)
    softmax_stats.launches += 1
    return out


def clipped_prob_stats(x, w, b, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sa, cnt), each [N] float32. Columns past V never count as above;
    the caller adds the floor of the below-set with the true vocab size."""
    if not _on_cuda(x, "clipped_prob_stats"):
        return clipped_prob_stats_reference(x, w, b, lse)
    out = _launch_clipped_prob_stats(x, w, b, lse)
    clipped_prob_stats.launches += 1
    return out


def _launch_backward(x, w, b, lse, u, cc, lab_term, labels, _route: int = -1):
    """``_route`` as in ``_launch_softmax_stats``: 0 times or tests
    ``backward_kernel`` on bfloat16 inputs."""
    f32 = torch.float32
    n, e, v = _check_common(x, w, b, {
        "lse": (lse, f32), "u": (u, f32), "cc": (cc, f32), "lab_term": (lab_term, f32),
        "labels": (labels, torch.int32)})
    plan = sce_backward_plan(n, e, v, x.dtype, _route,
                             torch.cuda.get_device_properties(x.device).multi_processor_count)
    tile = ROW_TILE[x.dtype]
    v_pad = _round_up(v, BLOCK_V)
    dev = x.device
    dx = torch.empty((n, e), dtype=f32, device=dev)
    dz = torch.empty((n, v_pad), dtype=x.dtype, device=dev)
    dbg_parts = torch.empty(((n + tile - 1) // tile, v_pad), dtype=f32, device=dev)
    # the dx partials of the vocab groups; the launcher plans again and fails
    # if it needs more groups than this holds
    parts = torch.empty((plan.groups, n, e), dtype=f32, device=dev) if plan.groups > 1 else None
    _launch("vct_sce_backward", x,
            (w, b, lse, u, cc, lab_term, labels, dx, dz, dbg_parts, parts),
            (v, plan.groups, _route))
    return dx, dz, dbg_parts


def sce_backward_tiles(x, w, b, lse, u, cc, lab_term, labels
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dx [N, E] float32, dz [N, V_pad] compute dtype, dbg_parts
    [ceil(N / ROW_TILE), V_pad] float32), V_pad = round_up(V, BLOCK_V); the
    columns past V are zeros. ``dwg = dz^T @ x`` is left to one matrix
    product outside the kernel, as in the reference, and ``dbg =
    dbg_parts.sum(0)``. ``sce_backward_plan`` says which kernels run."""
    if not _on_cuda(x, "sce_backward_tiles"):
        return sce_backward_tiles_reference(x, w, b, lse, u, cc, lab_term, labels)
    out = _launch_backward(x, w, b, lse, u, cc, lab_term, labels)
    sce_backward_tiles.launches += 1
    return out


softmax_stats.launches = 0
clipped_prob_stats.launches = 0
sce_backward_tiles.launches = 0
WRAPPERS = (softmax_stats, clipped_prob_stats, sce_backward_tiles)
