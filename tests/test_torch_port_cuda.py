"""The CUDA decode kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip elsewhere. The machine with the card
has no JAX, so this file imports only torch and the port, and runs without
the repo's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Widths are small (E=128, H=4, F=256, 2 layers, vocab 600 padded to 1024 so
the argmax crosses blocks); ``chip_smoke.py`` checks the MSVD widths.
Tolerances: float32 1e-4 (summation order); bfloat16 0.08 absolute (a few
units in the last place of 8-bit-significand values of magnitude 2..4, as
in ``test_torch_port_kernels.py``). Tokens are equal except where the plain
logits' top-2 gap is below ``NEAR_TIE``.
"""

import pytest
import torch

from vct_tpu_torch.ops import decode_kernels as dk

B, E, F, H, L, TM, NL, V, V_PAD = 8, 128, 256, 4, 16, 7, 2, 600, 1024
NEAR_TIE = 1e-2
MEAN_BF16 = 2e-3  # mean abs difference; a misplaced rounding point exceeds it
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=8e-2, rtol=0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, dt, idx, b=B, seed=0):
    g = torch.Generator().manual_seed(seed)

    def n(*s, scale=1.0, dtype=dt):
        return (torch.randn(s, generator=g) * scale).to(dev, dtype)

    f32 = torch.float32
    w = {"wqkv": n(NL, E, 3 * E, scale=0.08), "bqkv": n(NL, 3 * E, scale=0.1),
         "wo": n(NL, E, E, scale=0.08), "bo": n(NL, E, scale=0.1),
         "wcq": n(NL, E, E, scale=0.08), "bcq": n(NL, E, scale=0.1),
         "wco": n(NL, E, E, scale=0.08), "bco": n(NL, E, scale=0.1),
         "w1": n(NL, E, F, scale=0.08), "b1": n(NL, F, scale=0.1),
         "w2": n(NL, F, E, scale=0.06), "b2": n(NL, E, scale=0.1)}
    for k in dk._NORM_KEYS:
        w[k] = (1 + n(NL, E, scale=0.1, dtype=f32)) if k.endswith("s") \
            else n(NL, E, scale=0.1, dtype=f32)
    kc, vc = n(NL, L, b, E), n(NL, L, b, E)
    kc[:, idx:] = 0
    vc[:, idx:] = 0
    mem_bias = torch.zeros((b, TM), device=dev)
    mem_bias[1::2, -3:] = dk.NEG_INF
    wg = torch.zeros((E, V_PAD), device=dev, dtype=dt)
    wg[:, :V] = n(E, V, scale=0.2)
    bg = torch.full((V_PAD,), dk.NEG_INF, device=dev)
    bg[:V] = n(V, scale=0.1, dtype=f32)
    fw = {"stacked": w, "norm_s": 1 + n(E, scale=0.1, dtype=f32),
          "norm_b": n(E, scale=0.1, dtype=f32), "wg": wg, "bg": bg}
    step = (n(b, E), kc, vc, n(NL, TM, b, E), n(NL, TM, b, E), mem_bias)
    return fw, step


def _gaps(x, fw):
    logits = dk._ln(x, fw["norm_s"], fw["norm_b"]) @ fw["wg"].float() + fw["bg"]
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu()


def _assert_tokens(got, want, gaps):
    bad = (got.cpu() != want.cpu())
    assert bool((gaps[bad] < NEAR_TIE).all()), (got, want, gaps)


def _clone(step):
    x, kc, vc, ck, cv, mb = step
    return x, kc.clone(), vc.clone(), ck, cv, mb


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx,l_view", [(0, 8), (6, 8), (13, 16), (9, None)])
def test_layers_step_kernel(cuda, dt, idx, l_view):
    fw, step = _inputs(cuda, dt, idx, seed=idx)
    s1, s2 = _clone(step), _clone(step)
    x_k, k_k, v_k = dk.fused_layers_step(*s1, fw["stacked"], idx, heads=H, l_view=l_view)
    x_r, k_r, v_r = dk.fused_layers_step_reference(*s2, fw["stacked"], idx, heads=H,
                                                   l_view=l_view)
    torch.cuda.synchronize()
    torch.testing.assert_close(x_k.float(), x_r.float(), **TOL[dt])
    if dt == torch.bfloat16:  # nearly every value agrees: same rounding points
        assert float((x_k.float() - x_r.float()).abs().mean()) < MEAN_BF16
    torch.testing.assert_close(k_k.float(), k_r.float(), **TOL[dt])
    torch.testing.assert_close(v_k.float(), v_r.float(), **TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 20])
def test_whole_step_kernel(cuda, dt, b):
    idx, l_view = 5, 8
    fw, step = _inputs(cuda, dt, idx, b=b, seed=100 + b)
    s1, s2 = _clone(step), _clone(step)
    launches = dk.fused_whole_step.launches
    tok_k, k_k, _ = dk.fused_whole_step(*s1, fw, idx, heads=H, l_view=l_view)
    x_r = dk._stack_reference(*s2, fw["stacked"], idx, H, l_view)
    tok_r = dk.fused_norm_generator_argmax_reference(x_r, fw["norm_s"], fw["norm_b"],
                                                     fw["wg"], fw["bg"])
    torch.cuda.synchronize()
    assert dk.fused_whole_step.launches == launches + 1
    torch.testing.assert_close(k_k.float(), s2[1].float(), **TOL[dt])
    _assert_tokens(tok_k, tok_r, _gaps(x_r, fw))
    assert int(tok_k.max()) < V


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_generator_argmax_kernel_and_first_index_ties(cuda, dt):
    fw, step = _inputs(cuda, dt, 0, b=40, seed=7)
    x = step[0]
    tok_k = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    tok_r = dk.fused_norm_generator_argmax_reference(x, fw["norm_s"], fw["norm_b"],
                                                     fw["wg"], fw["bg"])
    _assert_tokens(tok_k, tok_r, _gaps(x, fw))
    # column 500 (another block's tiles) duplicates column 20; both win
    wg, bg = fw["wg"].clone(), fw["bg"].clone()
    wg[:, 500] = wg[:, 20]
    bg[20] = bg[500] = 1e3
    tok = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"], wg, bg)
    assert tok.cpu().tolist() == [20] * 40


@pytest.mark.cuda
def test_window_poisons(cuda):
    fw, step = _inputs(cuda, torch.bfloat16, 8)
    tok, _, _ = dk.fused_whole_step(*_clone(step), fw, 8, heads=H, l_view=8)
    x, _, _ = dk.fused_layers_step(*_clone(step), fw["stacked"], 8, heads=H, l_view=8)
    torch.cuda.synchronize()
    assert bool((tok == -1).all()) and bool(torch.isnan(x.float()).all())


@pytest.mark.cuda
def test_wrapper_rejects_bad_layouts(cuda):
    fw, step = _inputs(cuda, torch.bfloat16, 2)
    x, kc, vc, ck, cv, mb = _clone(step)
    with pytest.raises(TypeError):
        dk.fused_layers_step(x.float(), kc, vc, ck, cv, mb, fw["stacked"], 2, heads=H)
    with pytest.raises(ValueError, match="contiguous"):
        dk.fused_layers_step(x, kc.transpose(2, 3).contiguous().transpose(2, 3),
                             vc, ck, cv, mb, fw["stacked"], 2, heads=H)
    with pytest.raises(ValueError, match="is on cpu"):
        dk.fused_norm_generator_argmax(x, fw["norm_s"].cpu(), fw["norm_b"],
                                       fw["wg"], fw["bg"])
