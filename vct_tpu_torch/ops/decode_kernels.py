"""The three greedy decode-step kernels, each beside its plain PyTorch version.

Port of the kernels on the serving path in ``vct_tpu/ops/pallas_decode.py``:

* ``fused_layers_step`` (``pallas_decode.py:516``) — one token through the
  whole decoder stack; x_out is NaN when ``idx >= l_view``;
* ``fused_norm_generator_argmax`` (``pallas_decode.py:811``) — final
  LayerNorm, vocab projection and first-win argmax without storing logits;
* ``fused_whole_step`` (``pallas_decode.py:581``) — both in one launch; the
  tokens are -1 when ``idx >= l_view``.

The public functions keep the reference's argument layout: caches
[NL, L, B, E], cross K/V [NL, Tm, B, E], memory bias [B, Tm] float32 (or
None), weight matrices [in, out] stacked on a leading layer axis in the
compute dtype, LayerNorm parameters float32, and a padded vocab whose pad
columns carry a ``NEG_INF`` bias. ``idx`` is a host int. Unlike the reference
(which returns new caches), row ``idx`` of ``k_cache``/``v_cache`` is written
in place; the same tensors are returned.

Dispatch: a wrapper given CPU tensors runs the ``*_reference`` version; given
CUDA tensors it launches the CUDA kernel (``csrc/decode_step.cu``) or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LN_EPS = 1e-5
STACK_KEYS = ("wqkv", "bqkv", "wo", "bo", "wcq", "bcq", "wco", "bco",
              "n1s", "n1b", "n2s", "n2b", "w1", "b1", "w2", "b2", "n3s", "n3b")
_NORM_KEYS = ("n1s", "n1b", "n2s", "n2b", "n3s", "n3b")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPAN = 1024  # LMAX in csrc/decode_step.cu


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


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    return True


def _expect(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


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


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _launch_step(x, k_cache, v_cache, ck, cv, mem_bias, stacked, idx, heads, l_view,
                 gen: Optional[Dict[str, torch.Tensor]]):
    from vct_tpu_torch.ops._build import load_library

    b, e, nl, big_l, tm, f, l = _check_stack(x, k_cache, v_cache, ck, cv, mem_bias,
                                             stacked, heads, l_view)
    dev = x.device
    v = 0
    if gen is not None:
        v = gen["wg"].shape[1]
        if v % 8:
            raise ValueError(f"vocab width {v} must be a multiple of 8")
        _expect(gen["norm_s"], "norm_s", (e,), torch.float32, dev)
        _expect(gen["norm_b"], "norm_b", (e,), torch.float32, dev)
        _expect(gen["wg"], "wg", (e, v), x.dtype, dev)
        _expect(gen["bg"], "bg", (v,), torch.float32, dev)
        out = torch.empty((b,), dtype=torch.int32, device=dev)
        keys = torch.empty((b,), dtype=torch.int64, device=dev)
    else:
        out = torch.empty_like(x)
        keys = None
    scratch = torch.empty((b * (5 * e + f),), dtype=torch.float32, device=dev)
    g = gen or {}
    tensors = [x, k_cache, v_cache, ck, cv, mem_bias,
               *(stacked[k] for k in STACK_KEYS),
               g.get("norm_s"), g.get("norm_b"), g.get("wg"), g.get("bg"),
               out, scratch, keys]
    ptrs = (ctypes.c_void_p * len(tensors))(*map(_ptr, tensors))
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.vct_decode_step(
            _DTYPE_CODE[x.dtype], ctypes.cast(ptrs, ctypes.c_void_p), b, e, heads, f,
            nl, big_l, tm, v, int(idx), l, int(gen is not None), _stream(dev))
    _raise_on(err, "decode_step kernel")
    return out


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


def fused_norm_generator_argmax(x, norm_scale, norm_bias, wg, bg) -> torch.Tensor:
    """LayerNorm -> vocab projection -> argmax (first index wins ties) ->
    token ids [B] int32; pad columns of ``wg`` need a ``NEG_INF`` bias."""
    if not _on_cuda(x, "fused_norm_generator_argmax"):
        return fused_norm_generator_argmax_reference(x, norm_scale, norm_bias, wg, bg)
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
    keys = torch.zeros((b,), dtype=torch.int64, device=dev)  # below every real key
    tok = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.vct_gen_argmax(_DTYPE_CODE[x.dtype], x.data_ptr(), norm_scale.data_ptr(),
                                 norm_bias.data_ptr(), wg.data_ptr(), bg.data_ptr(),
                                 keys.data_ptr(), tok.data_ptr(), b, e, v, _stream(dev))
    _raise_on(err, "gen_argmax kernel")
    fused_norm_generator_argmax.launches += 1
    return tok


fused_layers_step.launches = 0
fused_whole_step.launches = 0
fused_norm_generator_argmax.launches = 0
WRAPPERS = (fused_whole_step, fused_layers_step, fused_norm_generator_argmax)
