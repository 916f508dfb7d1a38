"""The port's fused attention route against the JAX Pallas kernels, on the CPU.

The JAX side runs its kernels as its own tests do (``interpret=True``, or the
dispatch with ``vct_tpu.ops.attention.FORCE_PALLAS_INTERPRET`` set); the port
runs its kernel route on the kernels' plain versions
(``vct_tpu_torch.ops.attention.KERNEL_ROUTE_ON_CPU``), including the
``autograd.Function`` whose backward is the plain version of the backward
kernel. The same numpy inputs (and one numpy keep mask) go to both.

Tolerances: float32 1e-5 forward and 1e-4 gradients (summation order);
bfloat16 one unit in the last place (2**-7 relative) on all but a few
elements that sit on a rounding boundary.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vct_tpu.ops.attention as jax_attention
import vct_tpu_torch.ops.attention as port_attention
from vct_tpu.config import ModelConfig, TPUConfig
from vct_tpu.decode import greedy_generate as jax_greedy
from vct_tpu.models.layers import MultiHeadAttention as JaxMHA
from vct_tpu.models.layers import TransformerEncoderLayer as JaxEncoderLayer
from vct_tpu.models.mmt4caption import MMT4Caption as JaxMMT4Caption
from vct_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from vct_tpu.ops.pallas_attention import fused_attention_trainable as jax_trainable
from vct_tpu_torch.convert import load_state_dict_into, state_dict_from_jax
from vct_tpu_torch.decode import greedy_generate
from vct_tpu_torch.models.layers import (
    Dropout,
    DropoutRng,
    MultiHeadAttention,
    TransformerEncoderLayer,
)
from vct_tpu_torch.models.mmt4caption import MMT4Caption
from vct_tpu_torch.ops import attention_kernels as ak

NEG_INF = -1e30
# tests/test_pallas.py's shapes, and one that passes the 128 * 128 gate
SHAPES = [(13, 13, 8, 96), (8, 16, 4, 64), (31, 13, 2, 128), (13, 13, 4, 64),
          (31, 13, 2, 96), (128, 130, 2, 16)]
BIASES = [None, "padding", "causal", "rows", "full"]
B = 2


def _bias(kind, rng, tq, tk, h):
    causal = np.where(np.tril(np.ones((tq, tk), bool)), 0.0, NEG_INF).astype(np.float32)
    if kind is None:
        return None
    if kind == "padding":  # [B, 1, 1, Tk]
        bias = np.zeros((B, 1, 1, tk), np.float32)
        bias[0, :, :, -3:] = NEG_INF
        return bias
    if kind == "causal":  # [1, 1, T, T]
        return causal[None, None]
    if kind == "rows":  # [B, 1, T, T]: causal + padding
        bias = np.repeat(causal[None, None], B, axis=0)
        bias[1, :, :, 1:3] = NEG_INF
        return bias
    bias = rng.standard_normal((B, h, tq, tk)).astype(np.float32)
    bias[0, 0, 0, 1:] = NEG_INF  # a row with one key left
    if kind == "masked":
        # A fully masked row. The TPU wrapper pads Tk to its sublane quantum and
        # spreads such a row over the pad columns too, so only the port is held
        # to it.
        bias[0, 0, 0] = NEG_INF
    return bias


def _cases():
    for shape in SHAPES:
        for kind in BIASES:
            if kind in ("causal", "rows") and shape[0] != shape[1]:
                continue
            yield pytest.param(shape, kind, id=f"{'x'.join(map(str, shape))}-{kind}")


def _inputs(shape, kind, seed=0):
    tq, tk, h, d = shape
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, tq, h, d), (B, tk, h, d), (B, tk, h, d), (B, tq, h, d)))
    keep = rng.random((B, h, tq, tk)) >= 0.3
    return q, k, v, w, _bias(kind, rng, tq, tk, h), keep


def _t(a, dtype=torch.float32):
    return None if a is None else torch.tensor(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("shape,kind", list(_cases()))
def test_fused_attention_matches_the_pallas_kernel(shape, kind):
    q, k, v, _, bias, _ = _inputs(shape, kind)
    want = jax_fused_attention(_j(q), _j(k), _j(v), _j(bias), interpret=True)
    got = ak.fused_attention(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)


def _both_with_grads(shape, kind, rate, dtype_t, dtype_j):
    q, k, v, w, bias, keep = _inputs(shape, kind, seed=1)
    keep = keep if rate > 0 else None
    out_j, vjp = jax.vjp(
        lambda q, k, v: jax_trainable(rate, True, q, k, v, _j(bias), _j(keep, bool)),
        _j(q, dtype_j), _j(k, dtype_j), _j(v, dtype_j))
    grads_j = vjp(_j(w, dtype_j))
    leaves = [_t(a, dtype_t).requires_grad_() for a in (q, k, v)]
    out_t = ak.fused_attention_trainable(*leaves, _t(bias), _t(keep, torch.bool), rate)
    out_t.backward(_t(w, dtype_t))
    return (out_t, [a.grad for a in leaves]), (out_j, grads_j)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape,kind", list(_cases()))
def test_trainable_forward_and_gradients_match_the_pallas_kernels(shape, kind, rate):
    (out_t, grads_t), (out_j, grads_j) = _both_with_grads(shape, kind, rate, torch.float32,
                                                          jnp.float32)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), atol=1e-5)
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape,kind", [((13, 13, 8, 96), "rows"), ((31, 13, 2, 128), "padding"),
                                        ((128, 130, 2, 16), None)])
def test_trainable_bfloat16_agrees_to_one_unit(shape, kind, rate):
    (out_t, grads_t), (out_j, grads_j) = _both_with_grads(shape, kind, rate, torch.bfloat16,
                                                          jnp.bfloat16)
    assert out_t.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads_t)
    for got, want in zip([out_t] + grads_t, [out_j] + list(grads_j)):
        got, want = _f32(got), _f32(want)
        off = np.abs(got - want) > 2.0 ** -7 * np.abs(want) + 1e-6
        # two units at most, and only where a float32 sum sat on a rounding boundary
        assert off.mean() < 2e-3, off.mean()
        np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=2e-3)


def test_fully_masked_row_is_uniform_over_the_real_keys():
    q, k, v, _, bias, _ = _inputs((13, 13, 4, 64), "masked")
    out = ak.fused_attention(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, :, 0].mean(axis=0), atol=1e-6)


def test_function_backward_matches_autograd_of_the_math_path(monkeypatch):
    """The hand-written backward against torch's own differentiation of the
    math path, with the same dropout mask from one generator state."""
    q, k, v, w, bias, _ = _inputs((31, 13, 2, 96), "padding", seed=2)
    monkeypatch.setattr(port_attention, "KERNEL_ROUTE_ON_CPU", True)
    monkeypatch.setattr(port_attention, "KERNEL_MIN_SCORES", 1)
    results = []
    for use_kernels in (True, False):
        leaves = [_t(a).requires_grad_() for a in (q, k, v)]
        drop = Dropout(0.3, DropoutRng(torch.Generator().manual_seed(5))).train()
        out, _ = port_attention.dot_product_attention(
            *leaves, _t(bias), dropout=drop, use_kernels=use_kernels)
        out.backward(_t(w))
        results.append([out.detach()] + [a.grad for a in leaves])
    for got, want in zip(*results):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_bias_gets_no_gradient_on_the_kernel_route_and_one_on_the_math_route(monkeypatch):
    q, k, v, w, bias, _ = _inputs((128, 130, 2, 16), "full")
    monkeypatch.setattr(port_attention, "KERNEL_ROUTE_ON_CPU", True)
    for use_kernels in (True, False):
        b = _t(bias).requires_grad_()
        out, _ = port_attention.dot_product_attention(_t(q), _t(k), _t(v), b,
                                                      use_kernels=use_kernels)
        if use_kernels:
            assert not out.requires_grad
        else:
            out.backward(_t(w))
            assert float(b.grad.abs().max()) > 0
    b = _t(bias).requires_grad_()
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out, _ = port_attention.dot_product_attention(*leaves, b, use_kernels=True)
    out.backward(_t(w))
    assert b.grad is None and all(a.grad is not None for a in leaves)


def test_eligibility_table(monkeypatch):
    def x(t, dtype=torch.float32):
        return torch.zeros((1, t, 2, 16), dtype=dtype)

    ok = port_attention._kernel_eligible
    # on the CPU nothing is eligible unless the test hook is on
    assert not ok(x(128), x(128), True, False)
    monkeypatch.setattr(port_attention, "KERNEL_ROUTE_ON_CPU", True)
    table = [
        (x(128), x(128), True, False, True),
        (x(128), x(256), True, False, True),
        (x(64), x(256), True, False, True),      # Tq * Tk at the gate
        (x(127), x(128), True, False, False),    # below the gate
        (x(31), x(13), True, False, False),      # the MSVD shapes stay on the math path
        (x(1), x(16384), True, False, False),    # a single-query decode step
        (x(128), x(128), False, False, False),   # the model has its kernels off
        (x(128), x(128), True, True, False),     # the kernels return no weights
        (x(128, torch.bfloat16), x(128, torch.bfloat16), True, False, True),
        (x(128, torch.float16), x(128, torch.float16), True, False, False),
    ]
    for q, k, use, weights, want in table:
        assert ok(q, k, use, weights) is want, (q.shape, k.shape, q.dtype, use, weights)
    # the JAX dispatch agrees on the structural rows once its backend gate is lifted
    monkeypatch.setattr(jax_attention, "FORCE_PALLAS_INTERPRET", True)
    assert jax_attention._pallas_eligible(jnp.zeros((1, 128, 2, 16)), jnp.zeros((1, 128, 2, 16)),
                                          True, False)
    assert not jax_attention._pallas_eligible(jnp.zeros((1, 1, 2, 16)),
                                              jnp.zeros((1, 128, 2, 16)), True, False)


def test_an_eligible_shape_the_kernels_cannot_carry_raises(monkeypatch):
    monkeypatch.setattr(port_attention, "KERNEL_ROUTE_ON_CPU", True)
    q = torch.zeros((1, 128, 2, 20))  # head width 20 is no multiple of 16
    with pytest.raises(ValueError, match="head width"):
        port_attention.dot_product_attention(q, q, q, use_kernels=True)


# ---------------------------------------------------------------------------
# modules: the kernel route inside the layers
# ---------------------------------------------------------------------------

E, H, FF, VOCAB, FRAMES, CAP_LEN = 64, 4, 128, 500, 127, 129


@pytest.fixture
def kernel_routes(monkeypatch):
    """Both packages on their kernel routes, as far as a CPU allows."""
    monkeypatch.setattr(jax_attention, "FORCE_PALLAS_INTERPRET", True)
    monkeypatch.setattr(port_attention, "KERNEL_ROUTE_ON_CPU", True)
    calls = {"n": 0, "inference": 0}
    apply, inference = ak._FusedAttention.apply, ak.fused_attention

    def counting(*args):
        calls["n"] += 1
        return apply(*args)

    def counting_inference(*args):
        calls["n"] += 1
        calls["inference"] += 1
        return inference(*args)

    monkeypatch.setattr(ak._FusedAttention, "apply", counting)
    monkeypatch.setattr(ak, "fused_attention", counting_inference)
    return calls


def _port_module(module, variables):
    report = load_state_dict_into(module, state_dict_from_jax({"params": variables["params"]}))
    assert not report["missing"] and not report["unexpected"], report
    return module.eval()


def test_multi_head_attention_on_the_kernel_route(kernel_routes):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, E)).astype(np.float32)
    mem = rng.standard_normal((2, 256, E)).astype(np.float32)
    pad = np.zeros((2, 256), bool)
    pad[1, 200:] = True
    bias = np.where(pad, NEG_INF, 0.0).astype(np.float32)[:, None, None, :]
    jm = JaxMHA(E, H, use_pallas=True)
    variables = jm.init(jax.random.PRNGKey(0), _j(x), _j(mem), _j(bias))
    want, _ = jm.apply(variables, _j(x), _j(mem), _j(bias))
    pm = _port_module(MultiHeadAttention(E, H, use_kernels=True), variables)
    got, weights = pm(_t(x), _t(mem), _t(bias))
    assert kernel_routes["n"] == 1 and weights is None
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    # asking for the weights takes the math path, and agrees
    got_w, weights = pm(_t(x), _t(mem), _t(bias), return_weights=True)
    assert kernel_routes["n"] == 1 and weights.shape == (2, H, 128, 256)
    np.testing.assert_allclose(_f32(got_w), _f32(got), atol=1e-5)


def test_encoder_layer_on_the_kernel_route(kernel_routes):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 128, E)).astype(np.float32)
    pad = np.zeros((2, 128), bool)
    pad[0, 100:] = True
    bias = np.where(pad, NEG_INF, 0.0).astype(np.float32)[:, None, None, :]
    jm = JaxEncoderLayer(E, H, FF, 0.0, "gelu", jnp.float32, use_pallas=True)
    variables = jm.init(jax.random.PRNGKey(1), _j(x), _j(bias))
    want = jm.apply(variables, _j(x), _j(bias))
    pm = _port_module(TransformerEncoderLayer(E, H, FF, "gelu", use_kernels=True), variables)
    got = pm(_t(x), _t(bias))
    assert kernel_routes["n"] == 1
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)


def _long_config():
    return ModelConfig.from_dict({
        "modal": ["m0"], "modal_shape": [24], "embed_dim": E, "dropout": 0.0,
        "vocab_size": VOCAB, "activation": "gelu",
        "video_encoder": {"layer": 1, "nhead": H, "feedforward": FF,
                          "mme": {"temporal": "encoding", "aggregation": "avg"}},
        "caption_decoder": {"layer": 2, "nhead": H, "feedforward": FF,
                            "sce_loss_alpha": 0.5},
    })


def _long_batch(seed=0):
    """The long recipe's shapes at B=2: 127 frames (row 1 padded from 90), a
    caption of 129 positions (row 1 padded from 70)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, FRAMES, 24)).astype(np.float32)
    mask = np.zeros((2, FRAMES), bool)
    mask[1, 90:] = True
    caps = rng.integers(1, VOCAB, (2, CAP_LEN)).astype(np.int32)
    caps[1, 70:] = 0
    return [feats], [mask], caps, caps == 0


@pytest.fixture(scope="module")
def long_pair():
    cfg = _long_config()
    tpu = TPUConfig(dtype="float32", use_pallas_attention=True, max_frames=FRAMES,
                    max_caption_len=CAP_LEN)
    jm = JaxMMT4Caption(cfg, tpu)
    feats, masks, caps, cap_pad = _long_batch()
    variables = jm.init(jax.random.PRNGKey(2), [_j(f) for f in feats],
                        [_j(m, bool) for m in masks], _j(caps, jnp.int32), _j(cap_pad, bool),
                        method=JaxMMT4Caption.caption_loss)
    variables = jax.tree_util.tree_map(np.array, variables)
    pm = MMT4Caption(cfg, tpu)
    report = load_state_dict_into(pm, state_dict_from_jax(variables))
    assert not report["missing"] and not report["unexpected"], report
    return jm, variables, pm.eval()


def test_teacher_forced_decoder_on_the_kernel_route(long_pair, kernel_routes):
    jm, variables, pm = long_pair
    feats, masks, caps, cap_pad = _long_batch()
    want, _, _ = jm.apply(variables, [_j(f) for f in feats], [_j(m, bool) for m in masks],
                          _j(caps, jnp.int32), _j(cap_pad, bool),
                          method=JaxMMT4Caption.caption_logits)
    with torch.no_grad():
        got, _, _ = pm.caption_logits([_t(f) for f in feats], [_t(m, torch.bool) for m in masks],
                                      _t(caps, torch.int32), _t(cap_pad, torch.bool))
    # 1 encoder layer + 2 decoder layers x (self, cross); no gradient can be
    # asked for here, so all five are the inference kernel
    assert kernel_routes["n"] == 5 and kernel_routes["inference"] == 5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=1e-4)


def test_long_recipe_loss_gradients_and_greedy_tokens(long_pair, kernel_routes):
    jm, variables, pm = long_pair
    feats, masks, caps, cap_pad = _long_batch(seed=4)
    jargs = ([_j(f) for f in feats], [_j(m, bool) for m in masks], _j(caps, jnp.int32),
             _j(cap_pad, bool))

    def loss_fn(params):
        return jm.apply({**variables, "params": params}, *jargs,
                        method=JaxMMT4Caption.caption_loss)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(variables["params"])
    pm.zero_grad()
    loss_p = pm.caption_loss([_t(f) for f in feats], [_t(m, torch.bool) for m in masks],
                             _t(caps, torch.int32), _t(cap_pad, torch.bool))
    loss_p.backward()
    assert kernel_routes["n"] == 5 and kernel_routes["inference"] == 0
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    named = dict(pm.named_parameters())
    assert set(want) == set(named)
    for key, ref in want.items():
        np.testing.assert_allclose(named[key].grad.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=1e-3, err_msg=key)
    # greedy decode: one encoder launch, every step a single-query math step
    kernel_routes["n"] = 0
    tokens_j, _ = jax_greedy(jm, variables, jargs[0], jargs[1], max_len=12)
    tokens_p, _ = greedy_generate(pm, [_t(f) for f in feats],
                                  [_t(m, torch.bool) for m in masks], max_len=12)
    assert kernel_routes["n"] == 1 and kernel_routes["inference"] == 1
    np.testing.assert_array_equal(tokens_p.numpy(), np.asarray(tokens_j))


def test_model_with_kernels_off_never_takes_the_kernel_route(kernel_routes):
    cfg = _long_config()
    pm = MMT4Caption(cfg, TPUConfig(dtype="float32", use_pallas_attention=False)).eval()
    pm.init_weights(torch.Generator().manual_seed(0))
    feats, masks, caps, cap_pad = _long_batch()
    with torch.no_grad():
        pm.caption_loss([_t(f) for f in feats], [_t(m, torch.bool) for m in masks],
                        _t(caps, torch.int32), _t(cap_pad, torch.bool))
    assert kernel_routes["n"] == 0
