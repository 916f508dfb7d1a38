"""The decode kernels, each beside its plain PyTorch version.

Port of the kernels in ``vct_tpu/ops/pallas_decode.py``:

* ``fused_layers_step`` (``pallas_decode.py:516``) — one token through the
  whole decoder stack; x_out is NaN when ``idx >= l_view``;
* ``fused_norm_generator_argmax`` (``pallas_decode.py:811``) — final
  LayerNorm, vocab projection and first-win argmax without storing logits;
* ``fused_whole_step`` (``pallas_decode.py:581``) — both in one launch; the
  tokens are -1 when ``idx >= l_view``;
* ``fused_norm_generator_topk`` (``pallas_decode.py:721``) — final LayerNorm,
  vocab projection, per-row top-k (lowest id wins ties) and logsumexp
  without storing logits: beam search's candidates;
* ``fused_layer_step`` (``pallas_decode.py:211``) — one decoder layer's step
  on un-stacked weights and [L, B, E] caches;
* ``fused_multi_step`` (``pallas_decode.py:1289``) — ``unroll`` greedy tokens
  per launch, embedding and argmax feedback inside; tokens are -1 when the
  window reaches past ``l_view``;
* ``fused_sequence_decode`` (``pallas_decode.py:997``) — the whole greedy
  caption in one launch (B <= 32).

The public functions keep the reference's argument layout: caches
[NL, L, B, E], cross K/V [NL, Tm, B, E], memory bias [B, Tm] float32 (or
None), weight matrices [in, out] stacked on a leading layer axis in the
compute dtype, LayerNorm parameters float32, and a padded vocab whose pad
columns carry a ``NEG_INF`` bias. ``idx`` is a host int. Unlike the reference
(which returns new caches), row ``idx`` of ``k_cache``/``v_cache`` is written
in place; the same tensors are returned.

Dispatch: a wrapper given CPU tensors runs the ``*_reference`` version; given
CUDA tensors it launches the CUDA kernel (``csrc/decode_step.cu``,
``csrc/gen_argmax.cu``, ``csrc/gen_topk.cu``, ``csrc/decode_multi.cu``) or
raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vct_tpu_torch.ops._checks import expect as _expect
from vct_tpu_torch.ops._checks import SMEM_LIMIT
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda
from vct_tpu_torch.ops._checks import raise_on as _raise_on
from vct_tpu_torch.ops._checks import stream as _stream

NEG_INF = -1e30
LN_EPS = 1e-5
STACK_KEYS = ("wqkv", "bqkv", "wo", "bo", "wcq", "bcq", "wco", "bco",
              "n1s", "n1b", "n2s", "n2b", "w1", "b1", "w2", "b2", "n3s", "n3b")
_NORM_KEYS = ("n1s", "n1b", "n2s", "n2b", "n3s", "n3b")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPAN = 1024  # LMAX in csrc/decode_common.cuh
TOPK_MAX = 32     # TOPK_MAX in csrc/gen_topk.cu: the widest beam the kernel carries
SEQUENCE_MAX_B = 32  # fused_sequence_decode's batch rule, kept from the reference


# ---------------------------------------------------------------------------
# plain PyTorch versions (same float schedule as the reference kernels)
# ---------------------------------------------------------------------------


def _mm(x, w, b):
    """x @ w + b with float32 products and accumulation -> float32."""
    return x.float() @ w.float() + b.float()


def _ln(x, s, b):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + LN_EPS) * s.float() + b.float()


def _attend(q, kc, vc, heads, bias):
    """Single-query attention: q [B, E] f32 over kc/vc [n, B, E], bias [B, n]
    or None -> [B, E] f32."""
    n, b, e = kc.shape
    d = e // heads
    scale = torch.rsqrt(torch.tensor(float(d), device=q.device))
    logits = torch.einsum("bhd,nbhd->bhn", q.view(b, heads, d),
                          kc.float().view(n, b, heads, d)) * scale
    if bias is not None:
        logits = logits + bias[:, None, :]
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhn,nbhd->bhd", w, vc.float().view(n, b, heads, d)).reshape(b, e)


def _stack_reference(x, k_cache, v_cache, ck, cv, mem_bias, w, idx, heads, l):
    nl, big_l = k_cache.shape[:2]
    e = x.shape[1]
    dt = x.dtype
    n = min(idx + 1, l)
    for li in range(nl):
        qkv = _mm(x, w["wqkv"][li], w["bqkv"][li])
        if idx < big_l:
            k_cache[li, idx] = qkv[:, e:2 * e].to(dt)
            v_cache[li, idx] = qkv[:, 2 * e:].to(dt)
        sa = _attend(qkv[:, :e], k_cache[li, :n], v_cache[li, :n], heads, None)
        sa = _mm(sa.to(dt), w["wo"][li], w["bo"][li])
        x1 = _ln(x.float() + sa, w["n1s"][li], w["n1b"][li])
        cq = _mm(x1.to(dt), w["wcq"][li], w["bcq"][li])
        ca = _attend(cq, ck[li], cv[li], heads, mem_bias)
        ca = _mm(ca.to(dt), w["wco"][li], w["bco"][li])
        x2 = _ln(x1 + ca, w["n2s"][li], w["n2b"][li])
        h1 = F.gelu(_mm(x2.to(dt), w["w1"][li], w["b1"][li])).to(dt)
        x3 = _ln(x2 + _mm(h1, w["w2"][li], w["b2"][li]), w["n3s"][li], w["n3b"][li])
        x = x3.to(dt)
    return x


def _round_up8(n: int) -> int:
    return (n + 7) // 8 * 8


def _window(k_cache, l_view):
    big_l = k_cache.shape[1]
    return big_l if l_view is None else l_view


def fused_layers_step_reference(x, k_cache, v_cache, ck, cv, mem_bias, weights,
                                idx: int, *, heads: int, l_view: Optional[int] = None):
    l = _window(k_cache, l_view)
    out = _stack_reference(x, k_cache, v_cache, ck, cv, mem_bias, weights, idx, heads, l)
    if idx >= l:
        out = torch.full_like(out, float("nan"))
    return out, k_cache, v_cache


def fused_norm_generator_argmax_reference(x, norm_scale, norm_bias, wg, bg):
    logits = _ln(x, norm_scale, norm_bias) @ wg.float() + bg.float()
    return torch.argmax(logits, dim=-1).to(torch.int32)  # first index of the max


def fused_whole_step_reference(x, k_cache, v_cache, ck, cv, mem_bias, weights,
                               idx: int, *, heads: int, l_view: Optional[int] = None):
    l = _window(k_cache, l_view)
    xs = _stack_reference(x, k_cache, v_cache, ck, cv, mem_bias, weights["stacked"],
                          idx, heads, l)
    tok = fused_norm_generator_argmax_reference(
        xs, weights["norm_s"], weights["norm_b"], weights["wg"], weights["bg"])
    if idx >= l:
        tok = torch.full_like(tok, -1)
    return tok, k_cache, v_cache


def topk_first_win(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis by k passes of first-win argmax -> (values
    [..., k], indices [..., k] int64): the lowest index wins among equal
    values, which ``torch.topk`` does not promise."""
    vals = vals.clone()
    out_v, out_i = [], []
    for _ in range(k):
        arg = torch.argmax(vals, dim=-1, keepdim=True)  # first index of the max
        out_v.append(torch.gather(vals, -1, arg))
        out_i.append(arg)
        vals.scatter_(-1, arg, float("-inf"))
    return torch.cat(out_v, dim=-1), torch.cat(out_i, dim=-1)


def fused_norm_generator_topk_reference(x, norm_scale, norm_bias, wg, bg, *, k: int):
    logits = _ln(x, norm_scale, norm_bias) @ wg.float() + bg.float()
    topv, topi = topk_first_win(logits, k)
    return topv, topi.to(torch.int32), torch.logsumexp(logits, dim=-1)


def _as_stack(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One layer's un-stacked weights viewed with a leading layer axis of 1."""
    return {k: weights[k].unsqueeze(0) for k in STACK_KEYS}


def fused_layer_step_reference(x, k_cache, v_cache, ck, cv, mem_bias, weights, idx: int, *,
                               heads: int):
    out = _stack_reference(x, k_cache.unsqueeze(0), v_cache.unsqueeze(0), ck.unsqueeze(0),
                           cv.unsqueeze(0), mem_bias, _as_stack(weights), idx, heads,
                           k_cache.shape[0])
    return out, k_cache, v_cache


def _embed_step(emb, pe, cur, pos: int, pad_id: int):
    """The decoder input of tokens ``cur`` [B] at position ``pos``: the
    embedding row (zero for ``pad_id``) plus the position's row, summed in
    float32 and rounded once to the compute dtype."""
    x = emb[cur.long()].float().masked_fill((cur == pad_id)[:, None], 0.0)
    return (x + pe[pos].float()).to(emb.dtype)


def fused_multi_step_reference(cur, k_cache, v_cache, ck, cv, mem_bias, emb, pe, weights,
                               w_idx: int, *, heads: int, unroll: int = 4, pad_id: int = 0,
                               l_view: Optional[int] = None):
    l = _window(k_cache, l_view)
    toks = []
    for j in range(unroll):
        pos = w_idx * unroll + j
        x = _embed_step(emb, pe, cur, pos, pad_id)
        cur, _, _ = fused_whole_step_reference(x, k_cache, v_cache, ck, cv, mem_bias,
                                               weights, pos, heads=heads, l_view=l)
        toks.append(cur)
    toks = torch.stack(toks, dim=1)
    if (w_idx + 1) * unroll > l:
        toks = torch.full_like(toks, -1)
    return toks, k_cache, v_cache


def fused_sequence_decode_reference(emb, pe, ck, cv, mem_bias, weights, *, heads: int,
                                    max_len: int, start_id: int, end_id: int,
                                    pad_id: int = 0):
    nl, _, b, e = ck.shape
    l_pad = _round_up8(max_len)
    ks = torch.zeros((nl, l_pad, b, e), dtype=ck.dtype, device=ck.device)
    vs = torch.zeros_like(ks)
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=ck.device)
    tokens[:, 0] = start_id
    done = torch.zeros((b,), dtype=torch.bool, device=ck.device)
    for i in range(max_len - 1):
        x = _embed_step(emb, pe, tokens[:, i], i, pad_id)
        nxt, _, _ = fused_whole_step_reference(x, ks, vs, ck, cv, mem_bias, weights, i,
                                               heads=heads)
        tokens[:, i + 1] = nxt
        done |= nxt == end_id
        if bool(done.all()):  # every later position keeps pad_id
            break
    return tokens


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _check_stack(x, k_cache, v_cache, ck, cv, mem_bias, w, heads, l_view):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; kernels take float32 or bfloat16")
    b, e = x.shape
    dt, dev = x.dtype, x.device
    nl, big_l = k_cache.shape[0], k_cache.shape[1]
    tm = ck.shape[1]
    f = w["w1"].shape[-1]
    if e % heads:
        raise ValueError(f"embed dim {e} not divisible by heads {heads}")
    if e % 8 or f % 8:
        raise ValueError(f"widths {e}, {f} must be multiples of 8 (16-byte weight loads)")
    l = big_l if l_view is None else l_view
    if not 0 < l <= big_l or l > _MAX_SPAN or tm > _MAX_SPAN:
        raise ValueError(f"window {l} / memory {tm} outside the kernel's span")
    _expect(x, "x", (b, e), dt, dev)
    _expect(k_cache, "k_cache", (nl, big_l, b, e), dt, dev)
    _expect(v_cache, "v_cache", (nl, big_l, b, e), dt, dev)
    _expect(ck, "ck", (nl, tm, b, e), dt, dev)
    _expect(cv, "cv", (nl, tm, b, e), dt, dev)
    if mem_bias is not None:
        _expect(mem_bias, "mem_bias", (b, tm), torch.float32, dev)
    shapes = {"wqkv": (nl, e, 3 * e), "bqkv": (nl, 3 * e), "wo": (nl, e, e),
              "bo": (nl, e), "wcq": (nl, e, e), "bcq": (nl, e), "wco": (nl, e, e),
              "bco": (nl, e), "w1": (nl, e, f), "b1": (nl, f), "w2": (nl, f, e),
              "b2": (nl, e)}
    for k in STACK_KEYS:
        if k in _NORM_KEYS:
            _expect(w[k], k, (nl, e), torch.float32, dev)
        else:
            _expect(w[k], k, shapes[k], dt, dev)
    return b, e, nl, big_l, tm, f, l


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_gen(gen, e, dt, dev) -> int:
    v = gen["wg"].shape[1]
    if v % 8:
        raise ValueError(f"vocab width {v} must be a multiple of 8")
    _expect(gen["norm_s"], "norm_s", (e,), torch.float32, dev)
    _expect(gen["norm_b"], "norm_b", (e,), torch.float32, dev)
    _expect(gen["wg"], "wg", (e, v), dt, dev)
    _expect(gen["bg"], "bg", (v,), torch.float32, dev)
    return v


def _step_pointers(x, k_cache, v_cache, ck, cv, mem_bias, stacked, gen, out, scratch, keys,
                   *extra):
    """The device pointers in ``StepArgs`` order (csrc/decode_common.cuh), then
    ``extra``; the tensors stay referenced by the caller until the launch."""
    g = gen or {}
    tensors = [x, k_cache, v_cache, ck, cv, mem_bias,
               *(stacked[k] for k in STACK_KEYS),
               g.get("norm_s"), g.get("norm_b"), g.get("wg"), g.get("bg"),
               out, scratch, keys, *extra]
    return (ctypes.c_void_p * len(tensors))(*map(_ptr, tensors))


def _launch_step(x, k_cache, v_cache, ck, cv, mem_bias, stacked, idx, heads, l_view,
                 gen: Optional[Dict[str, torch.Tensor]]):
    from vct_tpu_torch.ops._build import load_library

    b, e, nl, big_l, tm, f, l = _check_stack(x, k_cache, v_cache, ck, cv, mem_bias,
                                             stacked, heads, l_view)
    dev = x.device
    v = 0
    if gen is not None:
        v = _check_gen(gen, e, x.dtype, dev)
        out = torch.empty((b,), dtype=torch.int32, device=dev)
        keys = torch.empty((b,), dtype=torch.int64, device=dev)
    else:
        out = torch.empty_like(x)
        keys = None
    scratch = torch.empty((b * (5 * e + f),), dtype=torch.float32, device=dev)
    ptrs = _step_pointers(x, k_cache, v_cache, ck, cv, mem_bias, stacked, gen, out, scratch,
                          keys)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.vct_decode_step(
            _DTYPE_CODE[x.dtype], ctypes.cast(ptrs, ctypes.c_void_p), b, e, heads, f,
            nl, big_l, tm, v, int(idx), l, int(gen is not None), _stream(dev))
    _raise_on(err, "decode_step kernel")
    return out


def _launch_multi(cur, k_cache, v_cache, ck, cv, mem_bias, emb, pe, weights, *, heads,
                  l_view, i0, n_tok, seq, poison, tok_out, start_id, end_id, pad_id):
    """One launch of ``n_tok`` greedy tokens from position ``i0`` (csrc/
    decode_multi.cu): a window's raw argmax chain into ``tok_out`` [B, n_tok],
    or (``seq``) the whole caption into ``tok_out`` [B, max_len]."""
    from vct_tpu_torch.ops._build import load_library

    dt, dev = ck.dtype, ck.device
    b, e = ck.shape[2], ck.shape[3]
    # the stack's checks take x: a stand-in of the right shape, never read
    x = torch.empty((b, e), dtype=dt, device=dev)
    b, e, nl, big_l, tm, f, l = _check_stack(x, k_cache, v_cache, ck, cv, mem_bias,
                                             weights["stacked"], heads, l_view)
    v = _check_gen(weights, e, dt, dev)
    n_emb = emb.shape[0]
    _expect(emb, "emb", (n_emb, e), dt, dev)
    if pe.shape[0] < i0 + n_tok:
        raise ValueError(f"pe has {pe.shape[0]} rows; positions reach {i0 + n_tok}")
    _expect(pe, "pe", (pe.shape[0], e), dt, dev)
    if cur is not None:
        _expect(cur, "cur", (b,), torch.int32, dev, vector_loads=False)
    keys = torch.zeros((n_tok, b), dtype=torch.int64, device=dev)  # below every real key
    scratch = torch.empty((b * (5 * e + f),), dtype=torch.float32, device=dev)
    ptrs = _step_pointers(None, k_cache, v_cache, ck, cv, mem_bias, weights["stacked"],
                          weights, None, scratch, keys, emb, pe, cur, tok_out)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.vct_decode_multi(
            _DTYPE_CODE[dt], ctypes.cast(ptrs, ctypes.c_void_p), b, e, heads, f, nl, big_l,
            tm, v, l, n_emb, int(i0), int(n_tok), int(seq), int(poison), int(start_id),
            int(end_id), int(pad_id), tok_out.shape[1], _stream(dev))
    _raise_on(err, "decode_multi kernel")


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def fused_layers_step(x, k_cache, v_cache, ck, cv, mem_bias, weights, idx: int, *,
                      heads: int, l_view: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decoder stack's decode step -> (x_out [B, E], k_cache, v_cache with
    row ``idx`` written per layer). ``l_view`` attends only the first
    ``l_view`` cache rows; x_out is NaN when ``idx >= l_view``."""
    if not _on_cuda(x, "fused_layers_step"):
        return fused_layers_step_reference(x, k_cache, v_cache, ck, cv, mem_bias,
                                           weights, idx, heads=heads, l_view=l_view)
    out = _launch_step(x, k_cache, v_cache, ck, cv, mem_bias, weights, idx, heads,
                       l_view, None)
    fused_layers_step.launches += 1
    return out, k_cache, v_cache


def fused_whole_step(x, k_cache, v_cache, ck, cv, mem_bias, weights, idx: int, *,
                     heads: int, l_view: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The entire decode step in one launch -> (next tokens [B] int32,
    k_cache, v_cache). ``weights`` holds ``stacked``, ``norm_s``, ``norm_b``,
    ``wg`` [E, V_pad] and ``bg`` [V_pad] as ``extract_fast_weights`` builds
    them. Tokens are -1 when ``idx >= l_view``."""
    if not _on_cuda(x, "fused_whole_step"):
        return fused_whole_step_reference(x, k_cache, v_cache, ck, cv, mem_bias,
                                          weights, idx, heads=heads, l_view=l_view)
    tok = _launch_step(x, k_cache, v_cache, ck, cv, mem_bias, weights["stacked"], idx,
                       heads, l_view, weights)
    fused_whole_step.launches += 1
    return tok, k_cache, v_cache


def split_hi_lo(yn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``yn`` as two bfloat16 parts, ``hi = bf16(yn)`` and ``lo =
    bf16(yn - hi)``: ``hi + lo`` keeps about 16 mantissa bits of ``yn``, so
    ``hi @ w + lo @ w`` with float32 accumulation stands for the reference's
    float32 ``yn @ w`` on bfloat16 tensor cores. The tensor-core route of
    ``csrc/gen_argmax.cu`` splits the LayerNorm output this way."""
    hi = yn.to(torch.bfloat16)
    return hi, (yn - hi.float()).to(torch.bfloat16)


class GenArgmaxPlan(NamedTuple):
    """How ``csrc/gen_argmax.cu`` launches a call, field for field what
    ``vct_gen_argmax_plan`` reports. ``route`` 1 is the tensor-core route
    (bfloat16): tiles of ``rows`` batch rows against slabs of ``cols`` vocab
    columns, K in steps of ``kstep`` through ``stages`` ring stages, scratch
    of ``b_pad`` rows per part. ``route`` 0 is the CUDA-core route (float32):
    units of ``rows`` x ``cols``, ``n_tiles`` groups of 8 column tiles."""
    route: int
    rows: int
    cols: int
    kstep: int
    stages: int
    smem_bytes: int
    m_tiles: int
    n_tiles: int
    b_pad: int


def _tc_plan(b: int, v: int, epilogue_bytes_per_row: int) -> GenArgmaxPlan:
    """The tensor-core route's plan (``gen_tc_plan`` in csrc/gen_wgmma.cuh):
    batch tiles of 64 rows up to B = 64, of 128 above, 256-column slabs, K
    steps of 64 through 3 stages. Shared memory: 1 KB to reach a 1024-byte
    boundary; per stage the hi and the lo rows (128 bytes each) and the
    weight tile (pitch cols + 8); the epilogue's bytes per row."""
    rows, cols, kstep, stages = (64 if b <= 64 else 128), 256, 64, 3
    smem = 1024 + stages * (2 * rows * 128 + kstep * (cols + 8) * 2) + rows * epilogue_bytes_per_row
    m_tiles = -(-b // rows)
    return GenArgmaxPlan(1, rows, cols, kstep, stages, smem, m_tiles, -(-v // cols),
                         m_tiles * rows)


def _gen_route(b: int, e: int, v: int, dtype, route: int) -> int:
    """Raises on what neither route takes -> the route (-1: by the dtype)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}; kernels take float32 or bfloat16")
    if b < 1 or e < 8 or v < 8 or e % 8 or v % 8:
        raise ValueError(f"B={b}, widths {e}, {v}: B >= 1 and widths that are multiples of 8 "
                         f"(16-byte weight loads)")
    if route not in (-1, 0, 1) or (route == 1 and dtype != torch.bfloat16):
        raise ValueError(f"route {route} for {dtype}")
    return route if route >= 0 else (1 if dtype == torch.bfloat16 else 0)


def _fits(plan: GenArgmaxPlan, e: int) -> GenArgmaxPlan:
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"width {e} needs {plan.smem_bytes} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return plan


def gen_argmax_plan(b: int, e: int, v: int, dtype, route: int = -1) -> GenArgmaxPlan:
    """The launch plan of ``fused_norm_generator_argmax`` for x [b, e] and wg
    [e, v] of ``dtype``, as the C launcher forms it: a description for tests
    and readers, not on the launch path. ``route`` -1 picks by the dtype
    (bfloat16 -> tensor cores, float32 -> CUDA cores); 0 or 1 asks for that
    route. Raises on what the kernels do not take."""
    if _gen_route(b, e, v, dtype, route) == 1:
        return _fits(_tc_plan(b, v, 8 * 8), e)  # 8 warps' keys a row
    return _fits(GenArgmaxPlan(0, 8, 32, 0, 0, 4 * (8 * e + 8 * 8 * 32), -(-b // 8),
                               -(-(-(-v // 32)) // 8), 0), e)


def _launch_gen_argmax(x, norm_scale, norm_bias, wg, bg, _route: int = -1) -> torch.Tensor:
    """``_route`` -1 leaves the choice to the launcher's rule on the dtype, as
    every caller in the package does; only checks set it, to time or test the
    CUDA-core kernel (0) on bfloat16 inputs."""
    from vct_tpu_torch.ops._build import load_library

    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; kernels take float32 or bfloat16")
    b, e = x.shape
    v = wg.shape[1]
    dev = x.device
    if e % 8 or v % 8:
        raise ValueError(f"widths {e}, {v} must be multiples of 8 (16-byte weight loads)")
    _expect(x, "x", (b, e), x.dtype, dev)
    _expect(norm_scale, "norm_scale", (e,), torch.float32, dev)
    _expect(norm_bias, "norm_bias", (e,), torch.float32, dev)
    _expect(wg, "wg", (e, v), x.dtype, dev)
    _expect(bg, "bg", (v,), torch.float32, dev)
    tensor_cores = x.dtype == torch.bfloat16 and _route != 0
    # 64-bit argmax keys (0 is below every real key) and a count of finished
    # blocks; the tensor-core route zeroes them in its prologue
    keys = (torch.empty if tensor_cores else torch.zeros)((b + 1,), dtype=torch.int64, device=dev)
    tok = torch.empty((b,), dtype=torch.int32, device=dev)
    # the LayerNorm output's two bfloat16 parts, written by the kernel's
    # prologue: whole batch tiles of 64 rows up to B = 64, of 128 above
    rows = 64 if b <= 64 else 128
    parts = (torch.empty((2, -(-b // rows) * rows, e), dtype=torch.bfloat16, device=dev)
             if tensor_cores else None)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.vct_gen_argmax(_DTYPE_CODE[x.dtype], x.data_ptr(), norm_scale.data_ptr(),
                                 norm_bias.data_ptr(), wg.data_ptr(), bg.data_ptr(),
                                 keys.data_ptr(), tok.data_ptr(),
                                 None if parts is None else parts.data_ptr(), b, e, v,
                                 _route, _stream(dev))
    _raise_on(err, "gen_argmax kernel")
    return tok


def fused_norm_generator_argmax(x, norm_scale, norm_bias, wg, bg) -> torch.Tensor:
    """LayerNorm -> vocab projection -> argmax (first index wins ties) ->
    token ids [B] int32; pad columns of ``wg`` need a ``NEG_INF`` bias."""
    if not _on_cuda(x, "fused_norm_generator_argmax"):
        return fused_norm_generator_argmax_reference(x, norm_scale, norm_bias, wg, bg)
    tok = _launch_gen_argmax(x, norm_scale, norm_bias, wg, bg)
    fused_norm_generator_argmax.launches += 1
    return tok


def gen_topk_plan(b: int, e: int, v: int, k: int, dtype, route: int = -1) -> GenArgmaxPlan:
    """The launch plan of ``fused_norm_generator_topk`` for x [b, e], wg [e,
    v] of ``dtype`` and ``k`` candidates a row, as the C launcher
    (``vct_gen_topk_plan``) forms it: a description for tests and readers, not
    on the launch path. ``route`` -1 picks by the dtype: bfloat16 takes the
    tensor-core route of ``gen_argmax_plan`` (the same tiles and ring, and
    per warp and row a key and a float plus per row a key for the top-k
    epilogue); float32 takes ``gen_topk_partial`` (units of 8 rows x 256
    columns, ``n_tiles`` column blocks). Both end in the fixed-order merge.
    Raises on what the kernels do not take."""
    route = _gen_route(b, e, v, dtype, route)
    if not 1 <= k <= min(TOPK_MAX, v):
        raise ValueError(f"k={k} outside 1..{min(TOPK_MAX, v)}")
    if route == 1:
        return _fits(_tc_plan(b, v, 8 * 12 + 8), e)
    return _fits(GenArgmaxPlan(0, 8, 256, 0, 0, 4 * (8 * e + 8 * 8 * 32 + 8 * 256),
                               -(-b // 8), -(-v // 256), 0), e)


def _launch_gen_topk(x, norm_scale, norm_bias, wg, bg, k: int, _route: int = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_route`` -1 leaves the choice to the launcher's rule on the dtype, as
    every caller in the package does; only checks set it, to time or test the
    CUDA-core kernel (0) on bfloat16 inputs."""
    from vct_tpu_torch.ops._build import load_library

    if k > TOPK_MAX:
        raise ValueError(f"k={k} above {TOPK_MAX}, the widest top-k the kernel carries")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x has dtype {x.dtype}; kernels take float32 or bfloat16")
    b, e = x.shape
    dev = x.device
    if e % 8:
        raise ValueError(f"width {e} must be a multiple of 8 (16-byte weight loads)")
    _expect(x, "x", (b, e), x.dtype, dev)
    v = _check_gen({"norm_s": norm_scale, "norm_b": norm_bias, "wg": wg, "bg": bg}, e,
                   x.dtype, dev)
    lib = load_library()
    n_blk = lib.vct_gen_topk_blocks(v)
    part_key = torch.empty((b, n_blk, k), dtype=torch.int64, device=dev)
    part_m = torch.empty((b, n_blk), dtype=torch.float32, device=dev)
    part_s = torch.empty((b, n_blk), dtype=torch.float32, device=dev)
    topv = torch.empty((b, k), dtype=torch.float32, device=dev)
    topi = torch.empty((b, k), dtype=torch.int32, device=dev)
    lse = torch.empty((b,), dtype=torch.float32, device=dev)
    # the LayerNorm output's two bfloat16 parts for the tensor-core route, as
    # for the argmax: whole batch tiles of 64 rows up to B = 64, of 128 above
    rows = 64 if b <= 64 else 128
    parts = (torch.empty((2, -(-b // rows) * rows, e), dtype=torch.bfloat16, device=dev)
             if x.dtype == torch.bfloat16 and _route != 0 else None)
    with torch.cuda.device(dev):
        err = lib.vct_gen_topk(_DTYPE_CODE[x.dtype], x.data_ptr(), norm_scale.data_ptr(),
                               norm_bias.data_ptr(), wg.data_ptr(), bg.data_ptr(),
                               part_key.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
                               topv.data_ptr(), topi.data_ptr(), lse.data_ptr(),
                               None if parts is None else parts.data_ptr(), b, e, v, k, _route,
                               _stream(dev))
    _raise_on(err, "gen_topk kernel")
    return topv, topi, lse


def fused_norm_generator_topk(x, norm_scale, norm_bias, wg, bg, *, k: int
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm -> vocab projection -> per-row top-k and logsumexp -> (values
    [B, k] float32, ids [B, k] int32, lse [B] float32); the [B, V] logits are
    never stored. ``values - lse[:, None]`` are the k largest log-softmax
    entries of each row, so beam search forms its candidates from k numbers
    per beam. The lowest id wins among equal logits; the result does not
    change from run to run. The kernel carries 1 <= k <= ``TOPK_MAX`` and
    raises above it; the plain version (CPU tensors) takes any k up to the
    vocab width."""
    if not 1 <= k <= wg.shape[1]:
        raise ValueError(f"k={k} outside 1..{wg.shape[1]}, the vocab width")
    if not _on_cuda(x, "fused_norm_generator_topk"):
        return fused_norm_generator_topk_reference(x, norm_scale, norm_bias, wg, bg, k=k)
    out = _launch_gen_topk(x, norm_scale, norm_bias, wg, bg, k)
    fused_norm_generator_topk.launches += 1
    return out


def fused_layer_step(x, k_cache, v_cache, ck, cv, mem_bias, weights, idx: int, *,
                     heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer's decode step -> (x_out [B, E], k_cache, v_cache with
    row ``idx`` written). Caches [L, B, E], cross K/V [Tm, B, E], ``mem_bias``
    [B, Tm] float32 or None, ``weights`` one layer's un-stacked set (wqkv
    [E, 3E], ..., n3b [E]); the whole cache is the window."""
    if not _on_cuda(x, "fused_layer_step"):
        return fused_layer_step_reference(x, k_cache, v_cache, ck, cv, mem_bias, weights,
                                          idx, heads=heads)
    out = _launch_step(x, k_cache.unsqueeze(0), v_cache.unsqueeze(0), ck.unsqueeze(0),
                       cv.unsqueeze(0), mem_bias, _as_stack(weights), idx, heads, None, None)
    fused_layer_step.launches += 1
    return out, k_cache, v_cache


def fused_multi_step(cur, k_cache, v_cache, ck, cv, mem_bias, emb, pe, weights, w_idx: int,
                     *, heads: int, unroll: int = 4, pad_id: int = 0,
                     l_view: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``unroll`` greedy steps in one launch -> (tokens [B, unroll] int32, the
    raw argmax chain; k_cache, v_cache with rows [w_idx * unroll, w_idx *
    unroll + unroll) written in place). ``cur`` [B] int32 is the window's
    first input token, ``emb`` [V, E] and ``pe`` [>= L, E] the embedding and
    position tables in the compute dtype, ``pad_id`` the embedding row forced
    to zero, ``weights`` as ``fused_whole_step`` takes them.

    ``l_view`` must cover every row the window touches: the tokens are -1
    whenever ``(w_idx + 1) * unroll > l_view``. The all-rows-finished -> pad
    rule stays with the caller, between windows."""
    big_l = k_cache.shape[1]
    l = big_l if l_view is None else l_view
    if unroll < 1 or big_l % unroll or l % unroll or not 0 < l <= big_l:
        raise ValueError(f"unroll {unroll} must divide the cache rows {big_l} and the "
                         f"window {l}")
    if not _on_cuda(ck, "fused_multi_step"):
        return fused_multi_step_reference(cur, k_cache, v_cache, ck, cv, mem_bias, emb, pe,
                                          weights, w_idx, heads=heads, unroll=unroll,
                                          pad_id=pad_id, l_view=l)
    tok = torch.empty((ck.shape[2], unroll), dtype=torch.int32, device=ck.device)
    _launch_multi(cur, k_cache, v_cache, ck, cv, mem_bias, emb, pe, weights, heads=heads,
                  l_view=l, i0=w_idx * unroll, n_tok=unroll, seq=False,
                  poison=(w_idx + 1) * unroll > l, tok_out=tok, start_id=0, end_id=-1,
                  pad_id=pad_id)
    fused_multi_step.launches += 1
    return tok, k_cache, v_cache


def fused_sequence_decode(emb, pe, ck, cv, mem_bias, weights, *, heads: int, max_len: int,
                          start_id: int, end_id: int, pad_id: int = 0) -> torch.Tensor:
    """The whole greedy generation in one launch -> tokens [B, max_len] int32,
    B <= ``SEQUENCE_MAX_B``. Same tokens as the per-token loop: once every
    row has emitted ``end_id`` the remaining positions are ``pad_id`` (the
    kernel leaves its token loop there). The self-attention caches are
    scratch of the launch: a token attends only rows already written, so
    they are left as allocated (the reference zeroes them first)."""
    nl, _, b, e = ck.shape
    if b > SEQUENCE_MAX_B:
        raise ValueError(f"sequence kernel takes B <= {SEQUENCE_MAX_B}, got {b}")
    if max_len < 2:
        raise ValueError(f"max_len {max_len} leaves no token to generate")
    if not _on_cuda(ck, "fused_sequence_decode"):
        return fused_sequence_decode_reference(emb, pe, ck, cv, mem_bias, weights,
                                               heads=heads, max_len=max_len,
                                               start_id=start_id, end_id=end_id,
                                               pad_id=pad_id)
    l_pad = _round_up8(max_len)
    ks = torch.empty((nl, l_pad, b, e), dtype=ck.dtype, device=ck.device)
    vs = torch.empty_like(ks)
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=ck.device)
    tokens[:, 0] = start_id
    _launch_multi(None, ks, vs, ck, cv, mem_bias, emb, pe, weights, heads=heads,
                  l_view=l_pad, i0=0, n_tok=max_len - 1, seq=True, poison=False,
                  tok_out=tokens, start_id=start_id, end_id=end_id, pad_id=pad_id)
    fused_sequence_decode.launches += 1
    return tokens


fused_layers_step.launches = 0
fused_whole_step.launches = 0
fused_norm_generator_argmax.launches = 0
fused_norm_generator_topk.launches = 0
fused_layer_step.launches = 0
fused_multi_step.launches = 0
fused_sequence_decode.launches = 0
WRAPPERS = (fused_whole_step, fused_layers_step, fused_norm_generator_argmax,
            fused_norm_generator_topk, fused_layer_step, fused_multi_step,
            fused_sequence_decode)
