"""The routed experts of a mixture-of-experts layer as CUDA kernels
(``csrc/moe_grouped.cu``), each beside its plain PyTorch version.

Replaces no TPU kernel: the JAX package runs no mixture-of-experts model.
They carry the LFM2 caption LM's expert layers (``models/lfm2.py``).

* ``moe_route(logits, bias, k)``: per token the top ``k`` experts of
  ``sigmoid(logits) + bias`` (ties to the lower expert) and the picks sorted
  by expert, then token, then pick -> ``Route``: ``idx`` [T, k] the experts,
  ``dest`` [T, k] each pick's row in the sorted order, ``src`` [T k] the
  token of each sorted row, ``offsets`` [E + 1] and ``counts`` [E], all
  int32 on the logits' device. Fixed sizes, no token dropped, nothing read
  back to the host: a CUDA graph can capture it.
* ``grouped_forward(a, w, offsets, a_map)``: ``out[r] = a[a_map[r]] @
  w[e(r)].T`` over the sorted rows (``a_map`` None: ``a[r]``), bfloat16 out.
* ``grouped_dx(g, w, offsets)``: ``out[r] = g[r] @ w[e(r)]``, bfloat16 out.
* ``grouped_dw(g, b, offsets, b_map)``: ``out[e] = sum over the rows r of e
  of g[r]^T b[b_map[r]]``, float32 [E, M, N].
* ``experts(x, w13, w2, route, dtype)``: the experts' SwiGLU outputs of
  every pick, in sorted order ([T k, H] in ``dtype``), through an
  ``autograd.Function`` whose backward is ``grouped_dw`` and ``grouped_dx``;
  the weights' gradients are float32, the token gradient sums each token's
  picks in float32 in pick order.

Every sum has a fixed order (no atomics): runs and graph replays give the
same bits. The plain versions loop over the experts with the offsets on the
host; they take CPU tensors, in any dtype, with float32 products rounded to
the inputs' dtype where the kernels round. Each wrapper counts its calls
that launch in ``<wrapper>.launches``. A CUDA tensor of another dtype than
bfloat16 raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vct_tpu_torch.ops._checks import expect as _expect
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda
from vct_tpu_torch.ops._checks import raise_on, stream

FWD_TILE_N = 256   # output columns of a forward or dX block (GW_BM)
FWD_TILE_K = 64    # their K step (GW_BK)
DW_TILE = 128      # dW: M and N of a block (GG_BM, GG_BN)
MAX_EXPERTS = 64   # RT_MAX_E
MAX_TOP_K = 8      # RT_MAX_K
MAX_ROWS = 98304   # RT_MAX_ROWS: picks (T k) a routing launch sorts


class Route(NamedTuple):
    idx: torch.Tensor       # [T, k] the chosen experts, best first
    dest: torch.Tensor      # [T, k] each pick's sorted row
    src: torch.Tensor       # [T k] the token of each sorted row
    offsets: torch.Tensor   # [E + 1] the first sorted row of each expert
    counts: torch.Tensor    # [E] rows of each expert


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def moe_route_reference(logits: torch.Tensor, bias: torch.Tensor, k: int) -> Route:
    score = torch.sigmoid(logits.float()) + bias.float()
    return route_of(torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k],
                    logits.shape[1])


def route_of(idx: torch.Tensor, e: int) -> Route:
    """The sorted order of the picks ``idx`` [T, k] over ``e`` experts."""
    t, k = idx.shape
    idx = idx.long()
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices          # sorted row -> pick
    dest = torch.empty_like(order)
    dest[order] = torch.arange(order.numel(), device=order.device)
    counts = torch.bincount(flat, minlength=e)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    i32 = torch.int32
    return Route(idx.to(i32), dest.view(t, k).to(i32), (order // k).to(i32), offsets.to(i32),
                 counts.to(i32))


def _ranges(offsets: torch.Tensor):
    off = [int(v) for v in offsets.tolist()]
    return list(enumerate(zip(off[:-1], off[1:])))


def grouped_forward_reference(a, w, offsets, a_map=None) -> torch.Tensor:
    out = torch.empty((int(offsets[-1]), w.shape[1]), dtype=a.dtype, device=a.device)
    for e, (lo, hi) in _ranges(offsets):
        rows = a[a_map[lo:hi].long()] if a_map is not None else a[lo:hi]
        out[lo:hi] = (rows.float() @ w[e].float().t()).to(a.dtype)
    return out


def grouped_dx_reference(g, w, offsets) -> torch.Tensor:
    out = torch.empty((g.shape[0], w.shape[2]), dtype=g.dtype, device=g.device)
    for e, (lo, hi) in _ranges(offsets):
        out[lo:hi] = (g[lo:hi].float() @ w[e].float()).to(g.dtype)
    return out


def grouped_dw_reference(g, b, offsets, b_map=None) -> torch.Tensor:
    n_e = offsets.numel() - 1
    out = torch.zeros((n_e, g.shape[1], b.shape[1]), dtype=torch.float32, device=g.device)
    for e, (lo, hi) in _ranges(offsets):
        rows = b[b_map[lo:hi].long()] if b_map is not None else b[lo:hi]
        out[e] = g[lo:hi].float().t() @ rows.float()
    return out


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _int_vector(t, name: str, n: int, device) -> None:
    _expect(t, name, (n,), torch.int32, device, vector_loads=False)


def _launch_route(logits, bias, k: int) -> Route:
    from vct_tpu_torch.ops._build import load_library

    if logits.ndim != 2:
        raise ValueError(f"logits of shape {tuple(logits.shape)}: expected [T, E]")
    t, e = logits.shape
    if not (1 <= e <= MAX_EXPERTS and 1 <= k <= min(MAX_TOP_K, e) and 1 <= t * k <= MAX_ROWS):
        raise ValueError(f"{t} tokens, {e} experts, top {k}: at most {MAX_EXPERTS} experts, "
                         f"k at most {MAX_TOP_K}, at most {MAX_ROWS} picks")
    dev = logits.device
    _expect(logits, "logits", (t, e), torch.float32, dev, vector_loads=False)
    _expect(bias, "bias", (e,), torch.float32, dev, vector_loads=False)
    i32 = dict(dtype=torch.int32, device=dev)
    route = Route(torch.empty((t, k), **i32), torch.empty((t, k), **i32),
                  torch.empty((t * k,), **i32), torch.empty((e + 1,), **i32),
                  torch.empty((e,), **i32))
    with torch.cuda.device(dev):
        err = load_library().vct_moe_route(logits.data_ptr(), bias.data_ptr(), t, e, k,
                                           *(x.data_ptr() for x in route), stream(dev))
    raise_on(err, "vct_moe_route")
    return route


def _check_rows(a, name: str, n: int, width: int, device) -> None:
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name} has dtype {a.dtype}; the kernels take bfloat16")
    _expect(a, name, (n, width), torch.bfloat16, device)


def _check_weights(w, device):
    if w.ndim != 3 or w.dtype != torch.bfloat16:
        raise TypeError(f"weights of shape {tuple(w.shape)} and dtype {w.dtype}: expected "
                        f"bfloat16 [E, ., .]")
    _expect(w, "w", tuple(w.shape), torch.bfloat16, device)
    if not 1 <= w.shape[0] <= MAX_EXPERTS:
        raise ValueError(f"{w.shape[0]} experts: at most {MAX_EXPERTS}")
    return w.shape


def _gemm(mode: int, a, a_map, b, b_map, offsets, out, e: int, r: int, m: int, n: int,
          k: int) -> None:
    from vct_tpu_torch.ops._build import load_library

    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(a.device):
        err = load_library().vct_grouped_gemm(mode, a.data_ptr(), ptr(a_map), b.data_ptr(),
                                              ptr(b_map), offsets.data_ptr(), out.data_ptr(),
                                              e, r, m, n, k, stream(a.device))
    raise_on(err, "vct_grouped_gemm")


def _launch_forward(a, w, offsets, a_map) -> torch.Tensor:
    e, n, k = _check_weights(w, a.device)
    r = a_map.shape[0] if a_map is not None else a.shape[0]
    if n % FWD_TILE_N or k % FWD_TILE_K or r < 1:
        raise ValueError(f"out width {n} must be a multiple of {FWD_TILE_N}, K {k} of "
                         f"{FWD_TILE_K}, rows {r} at least 1")
    _check_rows(a, "a", a.shape[0], k, a.device)
    if a_map is not None:
        _int_vector(a_map, "a_map", r, a.device)
    _int_vector(offsets, "offsets", e + 1, a.device)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=a.device)
    _gemm(0, a, a_map, w, None, offsets, out, e, r, 0, n, k)
    return out


def _launch_dx(g, w, offsets) -> torch.Tensor:
    e, k, n = _check_weights(w, g.device)
    r = g.shape[0]
    if n % FWD_TILE_N or k % FWD_TILE_K or r < 1:
        raise ValueError(f"out width {n} must be a multiple of {FWD_TILE_N}, K {k} of "
                         f"{FWD_TILE_K}, rows {r} at least 1")
    _check_rows(g, "g", r, k, g.device)
    _int_vector(offsets, "offsets", e + 1, g.device)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=g.device)
    _gemm(1, g, None, w, None, offsets, out, e, r, 0, n, k)
    return out


def _launch_dw(g, b, offsets, b_map) -> torch.Tensor:
    r, m = g.shape
    n = b.shape[1]
    e = offsets.shape[0] - 1
    if m % DW_TILE or n % DW_TILE or r < 1 or not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"widths {m} x {n} must be multiples of {DW_TILE}, rows {r} at least 1, "
                         f"experts {e} at most {MAX_EXPERTS}")
    _check_rows(g, "g", r, m, g.device)
    _check_rows(b, "b", b.shape[0], n, g.device)
    if b_map is not None:
        _int_vector(b_map, "b_map", r, g.device)
    elif b.shape[0] != r:
        raise ValueError(f"b has {b.shape[0]} rows and g {r}, and no b_map")
    _int_vector(offsets, "offsets", e + 1, g.device)
    out = torch.empty((e, m, n), dtype=torch.float32, device=g.device)
    _gemm(2, g, None, b, b_map, offsets, out, e, r, m, n, 0)
    return out


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def moe_route(logits: torch.Tensor, bias: torch.Tensor, k: int) -> Route:
    """``logits`` float32 [T, E], ``bias`` float32 [E] -> ``Route``."""
    if not _on_cuda(logits, "moe_route"):
        return moe_route_reference(logits, bias, k)
    out = _launch_route(logits, bias, k)
    moe_route.launches += 1
    return out


def grouped_forward(a, w, offsets, a_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a`` [., K], ``w`` [E, N, K], ``a_map`` [R] int32 or None -> [R, N]."""
    if not _on_cuda(a, "grouped_forward"):
        return grouped_forward_reference(a, w, offsets, a_map)
    out = _launch_forward(a, w, offsets, a_map)
    grouped_forward.launches += 1
    return out


def grouped_dx(g, w, offsets) -> torch.Tensor:
    """``g`` [R, K], ``w`` [E, K, N] -> [R, N]."""
    if not _on_cuda(g, "grouped_dx"):
        return grouped_dx_reference(g, w, offsets)
    out = _launch_dx(g, w, offsets)
    grouped_dx.launches += 1
    return out


def grouped_dw(g, b, offsets, b_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``g`` [R, M], ``b`` [., N], ``b_map`` [R] int32 or None -> float32
    [E, M, N]."""
    if not _on_cuda(g, "grouped_dw"):
        return grouped_dw_reference(g, b, offsets, b_map)
    out = _launch_dw(g, b, offsets, b_map)
    grouped_dw.launches += 1
    return out


moe_route.launches = 0
grouped_forward.launches = 0
grouped_dx.launches = 0
grouped_dw.launches = 0
WRAPPERS = (moe_route, grouped_forward, grouped_dx, grouped_dw)


# ---------------------------------------------------------------------------
# the experts of a layer, with their gradient
# ---------------------------------------------------------------------------


def swiglu(h13: torch.Tensor) -> torch.Tensor:
    """[R, 2I] (gate, then up) -> silu(gate) * up, in float32, rounded once."""
    gate, up = h13.float().chunk(2, dim=-1)
    return (F.silu(gate) * up).to(h13.dtype)


def swiglu_backward(h13: torch.Tensor, d_act: torch.Tensor) -> torch.Tensor:
    gate, up = h13.float().chunk(2, dim=-1)
    d = d_act.float()
    sg = torch.sigmoid(gate)
    d_gate = d * up * sg * (1.0 + gate * (1.0 - sg))
    return torch.cat([d_gate, d * gate * sg], dim=-1).to(h13.dtype)


class _Experts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w13, w2, src, dest, offsets, dtype):
        w13c, w2c = w13.to(dtype), w2.to(dtype)
        h13 = grouped_forward(x, w13c, offsets, src)
        act = swiglu(h13)
        y = grouped_forward(act, w2c, offsets)
        ctx.save_for_backward(x, w13c, w2c, src, dest, offsets, h13, act)
        ctx.dtypes = (x.dtype, w13.dtype, w2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w13c, w2c, src, dest, offsets, h13, act = ctx.saved_tensors
        x_dtype, w13_dtype, w2_dtype = ctx.dtypes
        gy = gy.contiguous()
        dw2 = grouped_dw(gy, act, offsets)
        dh13 = swiglu_backward(h13, grouped_dx(gy, w2c, offsets))
        dw13 = grouped_dw(dh13, x, offsets, src)
        dxs = grouped_dx(dh13, w13c, offsets)
        t, k = dest.shape
        dx = dxs.index_select(0, dest.reshape(-1).long()).view(t, k, -1).float().sum(1)
        return (dx.to(x_dtype), dw13.to(w13_dtype), dw2.to(w2_dtype), None, None, None, None)


def experts(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, route: Route,
            dtype: torch.dtype) -> torch.Tensor:
    """``x`` [T, H] in ``dtype``; ``w13`` [E, 2I, H] (gate rows, then up
    rows) and ``w2`` [E, H, I], cast to ``dtype`` here -> each pick's expert
    output [T k, H] in sorted order."""
    return _Experts.apply(x.contiguous(), w13, w2, route.src, route.dest, route.offsets, dtype)
