"""Fused LM-head + SCE loss: the [N, V] logits are never stored (port of
``vct_tpu/ops/fused_loss.py``).

The caption loss ``alpha * CE + (1 - alpha) * RCE`` is a function of three
per-position scalars: ``lse = logsumexp(z)``, ``zt = z[label]`` and
``S = sum_j clip(softmax(z)_j, 1e-7, 1)``. ``linear_sce_parts`` computes them
over vocab tiles and, in the backward pass, recomputes each tile's logits
instead of reading stored ones. Two routes, as in the reference:

* the kernel route (``ops.loss_kernels``: vocab tile 512) for eligible shapes
  on a CUDA device — ``softmax_stats`` and ``clipped_prob_stats`` forward,
  ``sce_backward_tiles`` backward, one matrix product ``dwg = dz^T @ x``
  outside the kernels;
* the chunked route for every other shape, on any device: plain loops over
  vocab chunks of ``block_v`` that never hold [N, V].

Both share the epilogues ``_ce_parts`` / ``_rce_parts`` and the backward
coefficients, and agree to float-summation order.

Layout: ``wg`` is the generator parameter in PyTorch's layout [V, E] (the
reference passes [E, V]); neither route transposes or copies it whole in
float32. The reference's ``stash`` option, its mesh wrappers and its VMEM
block-size rules are not ported.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vct_tpu_torch.ops import loss_kernels

LOG_OFF = math.log(1e-4)
EPS = 1e-7
# Row window of the kernel route, the reference's dispatch rule. Where the
# window should sit on this card is an open question (PERF.md).
KERNEL_MIN_N = 256
KERNEL_MAX_N = 4096
# Test hook: take the kernel route on CPU tensors too (the kernels' plain
# versions then stand in), so its epilogues and coefficients run off the card.
KERNEL_ROUTE_ON_CPU = False


def _kernel_ok(use_kernels: bool, x: torch.Tensor, wg: torch.Tensor, dtype) -> bool:
    """Eligibility of the kernel route (``vct_tpu/ops/fused_loss.py:184``). An
    eligible shape that the CUDA kernels cannot carry raises in their
    wrappers; it does not fall to the chunked route."""
    if not use_kernels:
        return False
    return (x.ndim == 2
            and KERNEL_MIN_N <= x.shape[0] <= KERNEL_MAX_N
            and x.shape[1] % 128 == 0
            and wg.shape[0] >= 2 * loss_kernels.BLOCK_V
            and dtype in (torch.bfloat16, torch.float32)
            and (x.is_cuda or KERNEL_ROUTE_ON_CPU))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32 from compute-dtype inputs
    (the reference's ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _ce_parts(lse, zt, keep_ce):
    return ((lse - zt) * keep_ce).sum(), keep_ce.sum()


def _rce_parts(sa, cnt, v: int, zt, lse, m_rce):
    """Reverse-CE sum/count from the clipped-prob stats; one copy of the clip
    formula for both routes. ``v`` is the true vocab size (pad columns are
    excluded from the floor of the below-set)."""
    s_clip = sa + EPS * (float(v) - cnt)
    pt_clip = torch.exp(zt - lse).clamp(min=EPS)
    rce = -LOG_OFF * (s_clip - pt_clip)
    return (rce * m_rce).sum(), m_rce.sum()


def _bwd_coefficients(g_ce, g_rce, keep_ce, m_rce, lse, zt, sa, with_rce: bool):
    """Per-row coefficients of ``dz_k = p_k * (u + c * a_k) - 1[k = t] *
    lab_term`` (``vct_tpu/ops/fused_loss.py:295-301``)."""
    pt = torch.exp(zt - lse)
    at = (pt > EPS).float()
    w_ce = g_ce * keep_ce
    c = (-LOG_OFF) * g_rce * m_rce if with_rce else torch.zeros_like(w_ce)
    base = c * (at * pt - sa)
    return w_ce + base, c, w_ce + c * at * pt


def _chunk_logits(x_dt, wg, bg, start: int, stop: int, dtype) -> torch.Tensor:
    """One vocab chunk's logits -> [N, stop - start] float32 holding
    compute-dtype values (float32-accumulated product rounded to ``dtype``,
    bias added in ``dtype``)."""
    z = torch.nn.functional.linear(x_dt, wg[start:stop].to(dtype))
    return (z + bg[start:stop].to(dtype)).float()


class _LinearSCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wg, bg, labels, keep_ce, m_rce, dtype, block_v, with_rce,
                kernels):
        """``kernels`` picks the route: the caller has decided it."""
        n = x.shape[0]
        v = wg.shape[0]
        x_dt = x.detach().to(dtype).contiguous()
        lab = labels.to(torch.int32).contiguous()
        keep_ce = keep_ce.float()
        m_rce = m_rce.float()
        sa = torch.zeros((n,), device=x.device)
        if kernels:
            w_dt, b_dt = loss_kernels.pad_generator(wg, bg, dtype)
            m, s, zt = loss_kernels.softmax_stats(x_dt, w_dt, b_dt, lab)
            lse = m + torch.log(s)
            if with_rce:
                sa, cnt = loss_kernels.clipped_prob_stats(x_dt, w_dt, b_dt, lse)
            saved = (x_dt, w_dt, b_dt)
        else:
            wg_d, bg_d = wg.detach(), bg.detach()
            chunks = [(s0, min(s0 + block_v, v)) for s0 in range(0, v, block_v)]
            m = torch.full((n,), float("-inf"), device=x.device)
            s = torch.zeros((n,), device=x.device)
            zt = torch.zeros((n,), device=x.device)
            for start, stop in chunks:
                z = _chunk_logits(x_dt, wg_d, bg_d, start, stop, dtype)
                m_new = torch.maximum(m, z.max(dim=-1).values)
                s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(dim=-1)
                m = m_new
                loc = lab.long() - start
                inside = (loc >= 0) & (loc < stop - start)
                z_at = z.gather(1, loc.clamp(0, stop - start - 1)[:, None])[:, 0]
                zt = torch.where(inside, z_at, zt)
            lse = m + torch.log(s)
            if with_rce:
                cnt = torch.zeros((n,), device=x.device)
                for start, stop in chunks:
                    p = torch.exp(_chunk_logits(x_dt, wg_d, bg_d, start, stop, dtype)
                                  - lse[:, None])
                    above = p > EPS
                    sa = sa + torch.where(above, p, 0.0).sum(dim=-1)
                    cnt = cnt + above.float().sum(dim=-1)
            saved = (x_dt, wg_d, bg_d)
        ce_sum, ce_n = _ce_parts(lse, zt, keep_ce)
        if with_rce:
            rce_sum, rce_n = _rce_parts(sa, cnt, v, zt, lse, m_rce)
        else:
            rce_sum = torch.zeros((), device=x.device)
            rce_n = torch.zeros((), device=x.device)
        ctx.save_for_backward(*saved, lab, keep_ce, m_rce, lse, zt, sa)
        ctx.route = (kernels, dtype, block_v, with_rce, v)
        ctx.in_dtypes = (x.dtype, wg.dtype, bg.dtype)
        ctx.mark_non_differentiable(ce_n, rce_n)
        return ce_sum, ce_n, rce_sum, rce_n

    @staticmethod
    def backward(ctx, g_ce, _g_ce_n, g_rce, _g_rce_n):
        x_dt, w, b, lab, keep_ce, m_rce, lse, zt, sa = ctx.saved_tensors
        kernels, dtype, block_v, with_rce, v = ctx.route
        u, c, lab_term = _bwd_coefficients(g_ce, g_rce, keep_ce, m_rce, lse, zt, sa, with_rce)
        if kernels:
            dx, dz, dbg_parts = loss_kernels.sce_backward_tiles(
                x_dt, w, b, lse, u.contiguous(), c.contiguous(), lab_term.contiguous(), lab)
            dwg = _matmul_f32(dz.t(), x_dt)[:v]
            dbg = dbg_parts.sum(dim=0)[:v]
        else:
            n, e = x_dt.shape
            dx = torch.zeros((n, e), device=x_dt.device)
            dwg = torch.empty((v, e), device=x_dt.device)
            dbg = torch.empty((v,), device=x_dt.device)
            for start in range(0, v, block_v):
                stop = min(start + block_v, v)
                p = torch.exp(_chunk_logits(x_dt, w, b, start, stop, dtype) - lse[:, None])
                dz = p * (u[:, None] + c[:, None] * (p > EPS).float())
                loc = lab.long() - start
                inside = (loc >= 0) & (loc < stop - start)
                dz.scatter_add_(1, loc.clamp(0, stop - start - 1)[:, None],
                                -torch.where(inside, lab_term, 0.0)[:, None])
                dz_dt = dz.to(dtype)  # the label term is subtracted before the rounding
                dx = dx + _matmul_f32(dz_dt, w[start:stop].to(dtype))
                dwg[start:stop] = _matmul_f32(dz_dt.t(), x_dt)
                dbg[start:stop] = dz.sum(dim=0)
        dt_x, dt_w, dt_b = ctx.in_dtypes
        return (dx.to(dt_x), dwg.to(dt_w), dbg.to(dt_b), None, None, None, None, None,
                None, None)


def linear_sce_parts(x: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor,
                     labels: torch.Tensor, keep_ce: torch.Tensor, m_rce: torch.Tensor,
                     dtype: torch.dtype = torch.float32, block_v: int = 2048,
                     with_rce: bool = True, use_kernels: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` [N, E] decoder outputs, ``wg`` [V, E] and ``bg`` [V] the generator
    parameters, ``labels`` [N] target ids, ``keep_ce`` / ``m_rce`` [N] float
    weights of the CE / RCE terms -> (ce_sum, ce_n, rce_sum, rce_n), the same
    four parts as ``losses.sce_loss_parts(generator(x), labels, ...)`` with
    ``keep_ce = (labels != pad) * valid`` and ``m_rce = rect_mask * valid``.
    With ``with_rce=False`` the rce parts are zeros (alpha == 1).
    ``use_kernels`` sends eligible shapes on a CUDA device to the CUDA
    kernels. Gradients flow to ``x``, ``wg`` and ``bg`` only."""
    return _LinearSCE.apply(x, wg, bg, labels, keep_ce, m_rce, dtype, block_v, with_rce,
                            _kernel_ok(use_kernels, x, wg, dtype))
