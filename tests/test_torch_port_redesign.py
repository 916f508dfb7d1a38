"""What the redesigned Hopper kernels rest on that a CPU can check: the hi/lo
split that lets bfloat16 tensor cores stand for a float32 ``yn @ wg``
(``csrc/gen_argmax.cu``), and the pure-Python launch plans that mirror the C
launchers of ``fused_norm_generator_argmax`` and of the attention forward
(``csrc/attention.cu``): route, tiles, stages and shared-memory bytes from the
shapes. The card tests (``test_torch_port_cuda.py``) hold each plan against
what the C launcher reports.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vct_tpu.ops import pallas_decode as ref
from vct_tpu_torch.ops import attention_kernels as ak
from vct_tpu_torch.ops import decode_kernels as dk

SMEM_LIMIT = 232448  # what one block may have on an H100
NEAR_TIE = 1e-2


# ---------------------------------------------------------------------------
# the hi/lo split
# ---------------------------------------------------------------------------


def _generator_inputs(seed, b, e, v, v_pad):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": n(b, e) * 2, "norm_s": 1.0 + 0.1 * n(e), "norm_b": 0.1 * n(e),
            "wg": np.pad(n(e, v) * 0.05, ((0, 0), (0, v_pad - v))),
            "bg": np.pad(n(v) * 0.1, (0, v_pad - v), constant_values=dk.NEG_INF)}


def _torch_inputs(a):
    bf16 = ("x", "wg")
    return {k: torch.tensor(v).to(torch.bfloat16) if k in bf16 else torch.tensor(v)
            for k, v in a.items()}


def _split_logits(t):
    """What the tensor-core route computes: hi @ wg + lo @ wg + bg in float32."""
    hi, lo = dk.split_hi_lo(dk._ln(t["x"], t["norm_s"], t["norm_b"]))
    w = t["wg"].float()
    return hi.float() @ w + lo.float() @ w + t["bg"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_plus_lo_rebuilds_float32_to_16_bits(seed):
    g = torch.Generator().manual_seed(seed)
    yn = torch.randn((64, 768), generator=g) * torch.logspace(-6, 3, 768)
    hi, lo = dk.split_hi_lo(yn)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.float() + lo.float() - yn).abs()
    assert bool((err <= 2.0 ** -15 * yn.abs()).all())
    assert bool((hi.float() == yn.to(torch.bfloat16).float()).all())


@pytest.mark.parametrize("seed", [3, 4])
def test_split_product_keeps_the_float32_logits_where_one_rounding_does_not(seed):
    """The reason for the split: at E=768 the logits from hi @ W + lo @ W stay
    within 1e-4 of the plain version's float32 ``yn @ W``; rounding ``yn`` to
    bfloat16 once (what a library bf16 product does) moves them by 1e-3 and
    more, enough to reorder near-ties that the reference resolves."""
    t = _torch_inputs(_generator_inputs(seed, 16, 768, 512, 512))
    yn = dk._ln(t["x"], t["norm_s"], t["norm_b"])
    w = t["wg"].float()
    plain = yn @ w + t["bg"]
    assert float((_split_logits(t) - plain).abs().max()) < 1e-4
    rounded_once = yn.to(torch.bfloat16).float() @ w + t["bg"]
    assert float((rounded_once - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("b,e", [(4, 128), (9, 768)])
def test_split_argmax_tokens_equal_the_jax_kernel(b, e):
    """argmax over the split product against ``vct_tpu``'s kernel (Pallas
    interpret mode) on the same bfloat16 inputs: equal except where the
    plain logits' top-2 gap is below ``NEAR_TIE``."""
    v, v_pad = 300, 384
    a = _generator_inputs(20 + b, b, e, v, v_pad)
    t = _torch_inputs(a)
    f32 = ("norm_s", "norm_b", "bg")
    ja = {k: jnp.asarray(x) if k in f32 else jnp.asarray(x).astype(jnp.bfloat16)
          for k, x in a.items()}
    tok_j = np.asarray(ref.fused_norm_generator_argmax(
        ja["x"], ja["norm_s"], ja["norm_b"], ja["wg"], ja["bg"], block_b=b, block_v=128,
        interpret=True))
    logits = _split_logits(t)
    tok_t = torch.argmax(logits, dim=-1).numpy()
    plain = dk._ln(t["x"], t["norm_s"], t["norm_b"]) @ t["wg"].float() + t["bg"]
    top = torch.topk(plain, 2, dim=-1).values
    gap = (top[:, 0] - top[:, 1]).numpy()
    assert np.all(gap[tok_t != tok_j] < NEAR_TIE), (tok_t, tok_j, gap)
    assert np.all(tok_t < v)
    want = dk.fused_norm_generator_argmax_reference(t["x"], t["norm_s"], t["norm_b"],
                                                    t["wg"], t["bg"]).numpy()
    assert np.all(gap[tok_t != want] < NEAR_TIE)


# ---------------------------------------------------------------------------
# the launch plan of fused_norm_generator_argmax
# ---------------------------------------------------------------------------

WIDTHS = [(768, 30720), (136, 1096), (8, 8), (2048, 50264), (6144, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,v", WIDTHS)
@pytest.mark.parametrize("b", [1, 7, 64, 65, 128, 200, 256, 1000])
def test_generator_argmax_plan_admits_and_fits(b, e, v, dtype):
    """Every B >= 1 and every pair of widths that are multiples of 8 has a
    plan, as before the redesign; the plan covers the rows and columns and
    fits a block's shared memory."""
    plan = dk.gen_argmax_plan(b, e, v, dtype)
    assert plan.route == (1 if dtype == torch.bfloat16 else 0)  # a dispatch on the dtype
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.m_tiles * plan.rows >= b > (plan.m_tiles - 1) * plan.rows
    if plan.route == 1:
        assert plan.rows == (64 if b <= 64 else 128) and plan.b_pad == plan.m_tiles * plan.rows
        assert (plan.cols, plan.kstep, plan.stages) == (256, 64, 3)
        assert plan.n_tiles * plan.cols >= v > (plan.n_tiles - 1) * plan.cols
        # alignment slack, the ring (hi and lo rows of 128 swizzled bytes, the
        # weight tile with a pitch of cols + 8 bfloat16) and eight warps' row keys
        assert plan.smem_bytes == 1024 + 3 * (2 * plan.rows * 128 + 64 * 264 * 2) \
            + 8 * plan.rows * 8
    else:
        assert (plan.rows, plan.cols, plan.b_pad) == (8, 32, 0)
        assert plan.n_tiles * 8 * 32 >= v
        assert plan.smem_bytes == 4 * (8 * e + 8 * 8 * 32)


def test_generator_argmax_plan_at_the_msvd_widths():
    plan = dk.gen_argmax_plan(128, 768, 30720, torch.bfloat16)
    assert plan == dk.GenArgmaxPlan(1, 128, 256, 64, 3, 208896, 1, 120, 128)
    assert dk.gen_argmax_plan(256, 768, 30720, torch.bfloat16).m_tiles == 2
    # the CUDA-core kernel stays reachable for bfloat16 by asking for it
    assert dk.gen_argmax_plan(128, 768, 30720, torch.bfloat16, route=0).route == 0


@pytest.mark.parametrize("b,e,v,dtype,route,error", [
    (0, 768, 30720, torch.bfloat16, -1, ValueError),
    (4, 100, 30720, torch.bfloat16, -1, ValueError),
    (4, 768, 30522, torch.bfloat16, -1, ValueError),
    (4, 768, 30720, torch.float16, -1, TypeError),
    (4, 768, 30720, torch.float32, 1, ValueError),   # no tensor-core route in float32
    (4, 16384, 1024, torch.float32, -1, ValueError),  # rows of this width do not fit
])
def test_generator_argmax_plan_refuses(b, e, v, dtype, route, error):
    with pytest.raises(error):
        dk.gen_argmax_plan(b, e, v, dtype, route)


# ---------------------------------------------------------------------------
# the launch plan of the attention forward
# ---------------------------------------------------------------------------

KEY_COUNTS = [1, 13, 64, 100, 255, 256, 257, 704, 705, 768, 769, 832, 833, 2000, 20000]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_keep", [False, True])
@pytest.mark.parametrize("d", [16, 48, 96, 128])
@pytest.mark.parametrize("tk", KEY_COUNTS)
def test_attention_forward_plan_admits_and_fits(tk, d, has_keep, dtype):
    """Any Tk >= 1 and any width that is a multiple of 16 up to 128 has a
    plan, as before the redesign: what does not fit on chip takes the
    two-pass route, whose shared memory does not grow with Tk."""
    plan = ak.attention_forward_plan(tk, d, dtype, has_keep)
    assert plan.smem_bytes <= SMEM_LIMIT
    if dtype == torch.float32:
        assert plan == ak.ForwardPlan(0, 32, 32, 1, plan.smem_bytes, 256)
        return
    logits = 64 * -(-tk // 64) * 64 * 4
    onchip = logits + 2 * (64 * (d + 8) * 2 + (64 * 80 if has_keep else 0))
    assert plan.route == (1 if onchip <= SMEM_LIMIT else 0)
    if plan.route == 1:
        assert plan == ak.ForwardPlan(1, 64, 64, 2, onchip, 256)
    else:
        assert (plan.tile_q, plan.tile_k, plan.stages, plan.threads) == (64, 64, 1, 256)
        assert plan.smem_bytes == ak.attention_forward_plan(64, d, dtype, has_keep, 0).smem_bytes


@pytest.mark.parametrize("d,has_keep,last_onchip", [
    (96, False, 768), (96, True, 704), (128, False, 768), (128, True, 704),
    (16, False, 832), (16, True, 832)])
def test_attention_forward_route_boundary_is_where_the_source_says(d, has_keep, last_onchip):
    bf16 = torch.bfloat16
    assert ak.attention_forward_plan(last_onchip, d, bf16, has_keep).route == 1
    assert ak.attention_forward_plan(last_onchip + 1, d, bf16, has_keep).route == 0
    with pytest.raises(ValueError):  # asked for by name where it does not fit
        ak.attention_forward_plan(last_onchip + 1, d, bf16, has_keep, route=1)
    assert ak.attention_forward_plan(last_onchip, d, bf16, has_keep, route=0).route == 0


def test_attention_forward_plan_at_the_long_recipe_shapes():
    bf16 = torch.bfloat16
    assert ak.attention_forward_plan(256, 96, bf16, False) == ak.ForwardPlan(
        1, 64, 64, 2, 92160, 256)
    assert ak.attention_forward_plan(256, 96, bf16, True).smem_bytes == 102400
    assert ak.attention_forward_plan(128, 96, bf16, False).smem_bytes == 59392
    # two blocks of the widest of them share an SM's 233,472 bytes (1 KB of
    # static row statistics and 1 KB reserved each)
    assert 2 * (102400 + 1024 + 1024) <= 233472


@pytest.mark.parametrize("tk,d,dtype,error", [
    (0, 96, torch.bfloat16, ValueError), (64, 100, torch.bfloat16, ValueError),
    (64, 144, torch.bfloat16, ValueError), (64, 8, torch.float32, ValueError),
    (64, 96, torch.float16, TypeError)])
def test_attention_forward_plan_refuses_what_the_wrappers_refuse(tk, d, dtype, error):
    with pytest.raises(error):
        ak.attention_forward_plan(tk, d, dtype, False)


def test_forward_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 9, 2, 16), (2, 11, 2, 16), (2, 11, 2, 16)))
    before = (ak.fused_attention.launches, ak.fused_attention_trainable.launches)
    torch.testing.assert_close(ak.fused_attention(q, k, v),
                               ak.fused_attention_reference(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(ak.fused_attention_trainable(q, k, v),
                               ak.fused_attention_trainable_reference(q, k, v), rtol=0, atol=0)
    assert (ak.fused_attention.launches, ak.fused_attention_trainable.launches) == before
