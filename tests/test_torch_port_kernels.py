"""The plain PyTorch versions of the decode kernels against the JAX kernels
(Pallas interpret mode), in float32 and bfloat16, on the same numpy inputs.

Tolerances: float32 1e-4 (summation order, and the reference kernel's
rational erf, max error 1.5e-7). bfloat16 keeps 8 significant bits: where
two float32 sums straddle a rounding boundary the rounded values differ by
one unit in the last place, 2**-6 at magnitudes 2..4 after a LayerNorm, and
that difference travels on through the later layers; 0.08 absolute bounds a
few such units. Tokens must be equal except where the plain logits' top-2
gap is below ``NEAR_TIE``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vct_tpu.ops import pallas_decode as ref
from vct_tpu_torch.ops import decode_kernels as dk

B, E, F, H, L, TM, NL = 4, 128, 256, 4, 16, 8, 2
V, V_PAD, BLOCK_V = 300, 384, 128
NEAR_TIE = 1e-2
DTYPES = {"float32": (torch.float32, jnp.float32, dict(atol=1e-4, rtol=1e-4)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, dict(atol=8e-2, rtol=0))}


def _inputs(seed, idx, dtype_name):
    """Caches hold rows < idx (row idx and later are zeros, as the decode
    loop leaves them); weights scaled so activations stay O(1)."""
    tdt, jdt, _ = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = {"wqkv": n(NL, E, 3 * E) * 0.08, "bqkv": n(NL, 3 * E) * 0.1,
         "wo": n(NL, E, E) * 0.08, "bo": n(NL, E) * 0.1,
         "wcq": n(NL, E, E) * 0.08, "bcq": n(NL, E) * 0.1,
         "wco": n(NL, E, E) * 0.08, "bco": n(NL, E) * 0.1,
         "w1": n(NL, E, F) * 0.08, "b1": n(NL, F) * 0.1,
         "w2": n(NL, F, E) * 0.06, "b2": n(NL, E) * 0.1}
    for k in dk._NORM_KEYS:
        w[k] = (1.0 + 0.1 * n(NL, E)) if k.endswith("s") else 0.1 * n(NL, E)
    kc, vc = n(NL, L, B, E), n(NL, L, B, E)
    kc[:, idx:] = 0.0
    vc[:, idx:] = 0.0
    mem_bias = np.zeros((B, TM), np.float32)
    mem_bias[1, -3:] = dk.NEG_INF
    arrays = {"x": n(B, E), "kc": kc, "vc": vc, "ck": n(NL, TM, B, E),
              "cv": n(NL, TM, B, E), "mem_bias": mem_bias,
              "norm_s": 1.0 + 0.1 * n(E), "norm_b": 0.1 * n(E),
              "wg": np.pad(n(E, V) * 0.2, ((0, 0), (0, V_PAD - V))),
              "bg": np.pad(n(V) * 0.1, (0, V_PAD - V), constant_values=dk.NEG_INF)}
    f32 = set(dk._NORM_KEYS) | {"mem_bias", "norm_s", "norm_b", "bg"}

    def t(k, a):  # a copy: jnp.asarray may share the numpy buffer on the CPU
        x = torch.tensor(a)
        return x if k in f32 else x.to(tdt)

    def j(k, a):
        return jnp.asarray(a) if k in f32 else jnp.asarray(a).astype(jdt)

    tw = {k: t(k, a) for k, a in w.items()}
    jw = {k: j(k, a) for k, a in w.items()}
    ta = {k: t(k, a) for k, a in arrays.items()}
    ja = {k: j(k, a) for k, a in arrays.items()}
    return tw, jw, ta, ja


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _top2_gap(x, ns, nb, wg, bg):
    logits = dk._ln(x, ns, nb) @ wg.float() + bg.float()
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).numpy()


def assert_tokens_match(got, want, gap):
    got, want = np.asarray(got), np.asarray(want)
    bad = got != want
    assert np.all(gap[bad] < NEAR_TIE), (got, want, gap)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx,l_view", [(0, 8), (5, 8), (9, 16), (11, None)])
def test_layers_step_reference_matches_jax_kernel(dtype_name, idx, l_view):
    tw, jw, ta, ja = _inputs(idx, idx, dtype_name)
    tol = DTYPES[dtype_name][2]
    x_j, k_j, v_j = ref.fused_layers_step(
        ja["x"], ja["kc"], ja["vc"], ja["ck"], ja["cv"], ja["mem_bias"], jw, idx,
        heads=H, block_b=B, l_view=l_view, interpret=True)
    x_t, k_t, v_t = dk.fused_layers_step_reference(
        ta["x"], ta["kc"], ta["vc"], ta["ck"], ta["cv"], ta["mem_bias"], tw, idx,
        heads=H, l_view=l_view)
    np.testing.assert_allclose(_f32(x_t), _f32(x_j), **tol)
    np.testing.assert_allclose(_f32(k_t), _f32(k_j), **tol)
    np.testing.assert_allclose(_f32(v_t), _f32(v_j), **tol)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx,l_view", [(3, 8), (12, 16)])
def test_whole_step_reference_matches_jax_kernel(dtype_name, idx, l_view):
    tw, jw, ta, ja = _inputs(100 + idx, idx, dtype_name)
    tol = DTYPES[dtype_name][2]
    jfw = {"stacked": jw, "norm_s": ja["norm_s"], "norm_b": ja["norm_b"],
           "wg": ja["wg"], "bg": ja["bg"]}
    tfw = {"stacked": tw, "norm_s": ta["norm_s"], "norm_b": ta["norm_b"],
           "wg": ta["wg"], "bg": ta["bg"]}
    tok_j, k_j, _ = ref.fused_whole_step(
        ja["x"], ja["kc"], ja["vc"], ja["ck"], ja["cv"], ja["mem_bias"], jfw, idx,
        heads=H, block_b=B, l_view=l_view, interpret=True)
    kc0 = ta["kc"].clone()
    tok_t, k_t, _ = dk.fused_whole_step_reference(
        ta["x"], ta["kc"], ta["vc"], ta["ck"], ta["cv"], ta["mem_bias"], tfw, idx,
        heads=H, l_view=l_view)
    np.testing.assert_allclose(_f32(k_t), _f32(k_j), **tol)
    x_stack = dk._stack_reference(ta["x"], kc0, ta["vc"].clone(), ta["ck"], ta["cv"],
                                  ta["mem_bias"], tw, idx, H, l_view)
    gap = _top2_gap(x_stack, ta["norm_s"], ta["norm_b"], ta["wg"], ta["bg"])
    assert_tokens_match(tok_t, tok_j, gap)
    assert np.all(np.asarray(tok_t) < V)  # padded vocab columns never win


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_window_poisons_match_jax_kernel(dtype_name):
    """idx outside the l_view window: NaN activations, -1 tokens."""
    idx, l_view = 8, 8
    tw, jw, ta, ja = _inputs(7, idx, dtype_name)
    x_j, _, _ = ref.fused_layers_step(
        ja["x"], ja["kc"], ja["vc"], ja["ck"], ja["cv"], ja["mem_bias"], jw, idx,
        heads=H, block_b=B, l_view=l_view, interpret=True)
    x_t, _, _ = dk.fused_layers_step_reference(
        ta["x"], ta["kc"], ta["vc"], ta["ck"], ta["cv"], ta["mem_bias"], tw, idx,
        heads=H, l_view=l_view)
    assert np.isnan(_f32(x_j)).all() and np.isnan(_f32(x_t)).all()
    tfw = {"stacked": tw, "norm_s": ta["norm_s"], "norm_b": ta["norm_b"],
           "wg": ta["wg"], "bg": ta["bg"]}
    tok_t, _, _ = dk.fused_whole_step_reference(
        ta["x"], ta["kc"], ta["vc"], ta["ck"], ta["cv"], ta["mem_bias"], tfw, idx,
        heads=H, l_view=l_view)
    assert (tok_t == -1).all()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_generator_argmax_reference_matches_jax_kernel(dtype_name):
    _, _, ta, ja = _inputs(11, 0, dtype_name)
    tok_j = ref.fused_norm_generator_argmax(ja["x"], ja["norm_s"], ja["norm_b"],
                                            ja["wg"], ja["bg"], block_b=B,
                                            block_v=BLOCK_V, interpret=True)
    tok_t = dk.fused_norm_generator_argmax_reference(ta["x"], ta["norm_s"],
                                                     ta["norm_b"], ta["wg"], ta["bg"])
    gap = _top2_gap(ta["x"], ta["norm_s"], ta["norm_b"], ta["wg"], ta["bg"])
    assert_tokens_match(tok_t, tok_j, gap)
    assert tok_t.dtype == torch.int32 and np.all(np.asarray(tok_t) < V)


def test_generator_argmax_tie_goes_to_the_first_index():
    """Column 250 (second vocab tile) duplicates column 10 (first tile) and
    both outscore the rest: both implementations return 10."""
    _, _, ta, ja = _inputs(12, 0, "float32")
    wg, bg = ta["wg"].clone(), ta["bg"].clone()
    wg[:, 250] = wg[:, 10]
    bg[10] = bg[250] = 100.0
    tok_t = dk.fused_norm_generator_argmax_reference(ta["x"], ta["norm_s"],
                                                     ta["norm_b"], wg, bg)
    tok_j = ref.fused_norm_generator_argmax(
        ja["x"], ja["norm_s"], ja["norm_b"], jnp.asarray(wg.numpy()),
        jnp.asarray(bg.numpy()), block_b=B, block_v=BLOCK_V, interpret=True)
    assert np.asarray(tok_j).tolist() == [10] * B
    assert tok_t.tolist() == [10] * B


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    tw, _, ta, _ = _inputs(13, 2, "float32")
    before = [w.launches for w in dk.WRAPPERS]
    x_w, _, _ = dk.fused_layers_step(ta["x"], ta["kc"].clone(), ta["vc"].clone(),
                                     ta["ck"], ta["cv"], None, tw, 2, heads=H, l_view=8)
    x_r, _, _ = dk.fused_layers_step_reference(ta["x"], ta["kc"].clone(),
                                               ta["vc"].clone(), ta["ck"], ta["cv"],
                                               None, tw, 2, heads=H, l_view=8)
    torch.testing.assert_close(x_w, x_r, rtol=0, atol=0)
    dk.fused_norm_generator_argmax(x_w, ta["norm_s"], ta["norm_b"], ta["wg"], ta["bg"])
    assert [w.launches for w in dk.WRAPPERS] == before


def test_wrappers_raise_for_a_device_without_a_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    is refused rather than moved."""
    x = torch.empty((B, E), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.fused_norm_generator_argmax(x, x[0], x[0], torch.empty((E, V_PAD),
                                       device="meta"), torch.empty(V_PAD, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.fused_layers_step(x, None, None, None, None, None, {}, 0, heads=H)
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.fused_whole_step(x, None, None, None, None, None, {}, 0, heads=H)
