"""The CUDA decode and loss kernels against their plain PyTorch versions, on
the card.

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


# ---------------------------------------------------------------------------
# top-k, one layer's step, several tokens per launch (csrc/gen_topk.cu,
# csrc/decode_multi.cu)
# ---------------------------------------------------------------------------


def _assert_topk(got, want, x, fw, dt, vocab=V):
    """Values and logsumexp within the dtype's tolerance; ids equal except
    where the plain logits of the two ids are within ``NEAR_TIE``; every id
    below ``vocab``."""
    (v_k, i_k, lse_k), (v_r, i_r, lse_r) = got, want
    torch.testing.assert_close(v_k, v_r, **TOL[dt])
    torch.testing.assert_close(lse_k, lse_r, **TOL[dt])
    logits = dk._ln(x, fw["norm_s"], fw["norm_b"]) @ fw["wg"].float() + fw["bg"]
    gap = (torch.gather(logits, 1, i_r.long()) - torch.gather(logits, 1, i_k.long())).abs()
    assert bool((gap[i_k != i_r] < NEAR_TIE).all()), (i_k, i_r)
    assert int(i_k.max()) < vocab and int(i_k.min()) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k", [(1, 1), (12, 4), (40, 8), (20, 16), (9, dk.TOPK_MAX)])
def test_generator_topk_kernel(cuda, dt, b, k):
    fw, step = _inputs(cuda, dt, 0, b=b, seed=200 + b)
    x = step[0]
    args = (x, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    launches = dk.fused_norm_generator_topk.launches
    got = dk.fused_norm_generator_topk(*args, k=k)
    again = dk.fused_norm_generator_topk(*args, k=k)
    want = dk.fused_norm_generator_topk_reference(*args, k=k)
    torch.cuda.synchronize()
    assert dk.fused_norm_generator_topk.launches == launches + 2
    _assert_topk(got, want, x, fw, dt)
    for a, c in zip(got, again):  # the same bits from run to run
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_generator_topk_ties_across_blocks_go_to_the_lowest_id(cuda, dt):
    """Columns 20, 300 and 590 (three column blocks of 256) share one weight
    column and lead the vocab: the ids come out in ascending order."""
    fw, step = _inputs(cuda, dt, 0, b=9, seed=9)
    wg, bg = fw["wg"].clone(), fw["bg"].clone()
    wg[:, 300] = wg[:, 590] = wg[:, 20]
    bg[20] = bg[300] = bg[590] = 1e3
    v, i, _ = dk.fused_norm_generator_topk(step[0], fw["norm_s"], fw["norm_b"], wg, bg, k=4)
    assert i[:, :3].cpu().tolist() == [[20, 300, 590]] * 9
    assert bool((v[:, 0] == v[:, 1]).all()) and bool((v[:, 1] == v[:, 2]).all())
    # above the kernel's cap a CUDA call raises; it never runs the plain version
    launches = dk.fused_norm_generator_topk.launches
    with pytest.raises(ValueError, match="above"):
        dk.fused_norm_generator_topk(step[0], fw["norm_s"], fw["norm_b"], wg, bg,
                                     k=dk.TOPK_MAX + 1)
    assert dk.fused_norm_generator_topk.launches == launches


@pytest.mark.cuda
def test_beam_wider_than_the_kernel_raises_on_the_card(cuda):
    """``beam_generate_fused`` (and so ``make_auto_beam_fn``) refuses a beam
    above ``TOPK_MAX`` on CUDA tensors before it encodes anything."""
    from vct_tpu_torch.decode_fast import beam_generate_fused

    feats = [torch.zeros((2, 4, 16), device=cuda)]
    with pytest.raises(ValueError, match="beam_size"):
        beam_generate_fused(None, feats, None, beam_size=dk.TOPK_MAX + 1, pad_id=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx,with_bias", [(0, True), (7, False), (15, True)])
def test_layer_step_kernel(cuda, dt, idx, with_bias):
    fw, step = _inputs(cuda, dt, idx, seed=300 + idx)
    x, kc, vc, ck, cv, mb = step
    w1 = {k: v[1].contiguous() for k, v in fw["stacked"].items()}
    mb = mb if with_bias else None
    launches = dk.fused_layer_step.launches
    x_k, k_k, v_k = dk.fused_layer_step(x, kc[1].clone(), vc[1].clone(), ck[1].contiguous(),
                                        cv[1].contiguous(), mb, w1, idx, heads=H)
    x_r, k_r, v_r = dk.fused_layer_step_reference(x, kc[1].clone(), vc[1].clone(), ck[1],
                                                  cv[1], mb, w1, idx, heads=H)
    torch.cuda.synchronize()
    assert dk.fused_layer_step.launches == launches + 1
    torch.testing.assert_close(x_k.float(), x_r.float(), **TOL[dt])
    torch.testing.assert_close(k_k.float(), k_r.float(), **TOL[dt])
    torch.testing.assert_close(v_k.float(), v_r.float(), **TOL[dt])


def _tables(dev, dt, seed=0):
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((V, E), generator=g).to(dev, dt)
    pe = (torch.randn((L, E), generator=g) * 0.5).to(dev, dt)
    return emb, pe


def _assert_chain(got, want, replay):
    """Token chains equal, or parting first at a near-tie: ``replay(row)``
    gives the plain logits' top-2 gaps [n_tok] along the wanted chain."""
    got, want = got.cpu(), want.cpu()
    for r in (got != want).any(dim=1).nonzero().flatten().tolist():
        first = int((got[r] != want[r]).int().argmax())
        assert float(replay(r)[first]) < NEAR_TIE, (r, first, got[r], want[r])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,u", [(1, 2), (8, 4), (20, 8)])
def test_multi_step_kernel_windows_and_poison(cuda, dt, b, u):
    fw, step = _inputs(cuda, dt, 0, b=b, seed=400 + b)
    _, kc, vc, ck, cv, mb = step
    emb, pe = _tables(cuda, dt)
    cur = torch.randint(1, V, (b,), generator=torch.Generator().manual_seed(b)
                        ).to(cuda, torch.int32)
    cur[0] = 0  # the pad row embeds to zero
    ks_k, vs_k, ks_r, vs_r = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    cur_k = cur_r = cur
    gaps = []
    launches = dk.fused_multi_step.launches
    for w in range(L // u):
        l_view = min(-(-((w + 1) * u) // 8) * 8, L)
        t_k, _, _ = dk.fused_multi_step(cur_k, ks_k, vs_k, ck, cv, mb, emb, pe, fw, w,
                                        heads=H, unroll=u, pad_id=0, l_view=l_view)
        # the plain version one token at a time, to read each step's top-2 gap
        toks = []
        for j in range(u):
            pos = w * u + j
            x = dk._embed_step(emb, pe, cur_r, pos, 0)
            xs = dk._stack_reference(x, ks_r, vs_r, ck, cv, mb, fw["stacked"], pos, H, l_view)
            gaps.append(_gaps(xs, fw))
            cur_r = dk.fused_norm_generator_argmax_reference(xs, fw["norm_s"], fw["norm_b"],
                                                             fw["wg"], fw["bg"])
            toks.append(cur_r)
        t_r = torch.stack(toks, dim=1)
        torch.cuda.synchronize()
        gap_w = torch.stack(gaps[-u:], dim=1)  # [b, u]
        _assert_chain(t_k, t_r, lambda r: gap_w[r])
        rows = slice(w * u, w * u + u)
        same = (t_k == t_r).all(dim=1)  # rows whose chains agree wrote the same cache rows
        torch.testing.assert_close(ks_k[:, rows][:, :, same].float(),
                                   ks_r[:, rows][:, :, same].float(), **TOL[dt])
        # go on from the plain chain so a near-tie does not travel
        ks_k[:, rows], vs_k[:, rows] = ks_r[:, rows], vs_r[:, rows]
        cur_k = cur_r = t_r[:, -1].contiguous()
    assert dk.fused_multi_step.launches == launches + L // u
    t_k, _, _ = dk.fused_multi_step(cur, kc.clone(), vc.clone(), ck, cv, mb, emb, pe, fw, 1,
                                    heads=H, unroll=u, pad_id=0, l_view=u)
    assert bool((t_k == -1).all())  # (1 + 1) * u > l_view


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_sequence_decode_kernel(cuda, dt, b):
    fw, step = _inputs(cuda, dt, 0, b=b, seed=500 + b)
    _, _, _, ck, cv, mb = step
    emb, pe = _tables(cuda, dt, seed=1)
    kw = dict(heads=H, max_len=14, start_id=2, pad_id=0)

    def replay(want):
        """Top-2 gaps of the plain logits along the chain ``want``."""
        nl = ck.shape[0]
        ks = torch.zeros((nl, L, b, E), dtype=dt, device=cuda)
        vs = torch.zeros_like(ks)
        gaps = []
        for i in range(want.shape[1] - 1):
            x = dk._embed_step(emb, pe, want[:, i], i, 0)
            gaps.append(_gaps(dk._stack_reference(x, ks, vs, ck, cv, mb, fw["stacked"], i, H,
                                                  L), fw))
        return torch.stack(gaps, dim=1)

    launches = dk.fused_sequence_decode.launches
    want = dk.fused_sequence_decode_reference(emb, pe, ck, cv, mb, fw, end_id=-1, **kw)
    got = dk.fused_sequence_decode(emb, pe, ck, cv, mb, fw, end_id=-1, **kw)
    torch.cuda.synchronize()
    assert got.shape == (b, 14) and got.dtype == torch.int32
    gaps = replay(want)
    _assert_chain(got[:, 1:], want[:, 1:], lambda r: gaps[r])
    # a generator biased to the end token: every row finishes at step 1 and
    # the kernel leaves its token loop there
    end_id = 5
    fw2 = dict(fw, bg=fw["bg"].clone())
    fw2["bg"][end_id] = 1e3
    want = dk.fused_sequence_decode_reference(emb, pe, ck, cv, mb, fw2, end_id=end_id, **kw)
    got = dk.fused_sequence_decode(emb, pe, ck, cv, mb, fw2, end_id=end_id, **kw)
    torch.cuda.synchronize()
    assert got.cpu().tolist() == want.cpu().tolist() == [[2, 5] + [0] * 12] * b
    assert dk.fused_sequence_decode.launches == launches + 2
    if b == 32:
        wide = torch.zeros((NL, TM, 33, E), dtype=dt, device=cuda)
        with pytest.raises(ValueError, match="B <= 32"):
            dk.fused_sequence_decode(emb, pe, wide, wide, None, fw, end_id=-1, **kw)


# ---------------------------------------------------------------------------
# the fused-loss kernels (csrc/sce_loss.cu)
# ---------------------------------------------------------------------------
# Tolerances: the float32 statistics and sums differ from the plain version by
# float-summation order (the product's k order, the warp reductions):
# rtol 2e-5 at float32, and for bfloat16 inputs the same since both round
# the logits tile to bfloat16 at the same point — but a logit on a rounding
# boundary may land one bfloat16 unit apart, which moves a row's statistic by
# up to 2**-8 of one probability; hence atol 2e-3 there. dz in bfloat16:
# one unit in the last place (2**-7 relative covers it) for all but the few
# elements whose logit landed one bfloat16 unit apart (a unit of 2**-5 at
# |z| < 8 moves p, and so dz, by up to 3%): under 0.1% of the elements may
# exceed one unit and none may exceed 5%.

LN, LE, LV = 300, 128, 1111


def _loss_inputs(dev, dt, n=LN, seed=0, zero_rows=True, e=LE, v=LV, padded=True):
    """``padded``: the generator padded to a multiple of 512 rows by
    ``pad_generator``; else as the fused loss passes it (cast only)."""
    from vct_tpu_torch.ops import loss_kernels as lk

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, e), generator=g).to(dev, dt)
    wg = (torch.randn((v, e), generator=g) / e ** 0.5).to(dev)
    bg = (torch.randn((v,), generator=g) * 0.1).to(dev)
    w, b = lk.pad_generator(wg, bg, dt) if padded else (wg.to(dt), bg.to(dt))
    labels = torch.randint(0, v, (n,), generator=g).to(dev, torch.int32)
    labels[:4] = v - 1   # the last, partial vocab tile
    labels[4:8] = 0
    rows = {k: torch.rand((n,), generator=g).to(dev) for k in ("u", "cc", "lt")}
    if zero_rows:
        for t in rows.values():
            t[8:16] = 0.0
    return lk, x, w, b, labels, rows


STAT_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-3, atol=2e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e", [(LN, LE), (256, LE), (33, LE), (33, 1664)])
def test_loss_forward_kernels(cuda, dt, n, e):
    lk, x, w, b, labels, _ = _loss_inputs(cuda, dt, n=n, seed=n, e=e)
    before = [fn.launches for fn in lk.WRAPPERS]
    m, s, zt = lk.softmax_stats(x, w, b, labels)
    m_r, s_r, zt_r = lk.softmax_stats_reference(x, w, b, labels)
    lse = m_r + torch.log(s_r)
    sa, cnt = lk.clipped_prob_stats(x, w, b, lse)
    sa_r, cnt_r = lk.clipped_prob_stats_reference(x, w, b, lse)
    torch.cuda.synchronize()
    assert [fn.launches for fn in lk.WRAPPERS] == [before[0] + 1, before[1] + 1, before[2]]
    torch.testing.assert_close(m + torch.log(s), lse, **STAT_TOL[dt])
    torch.testing.assert_close(zt, zt_r, **STAT_TOL[dt])
    torch.testing.assert_close(sa, sa_r, **STAT_TOL[dt])
    # a probability within rounding of 1e-7 may fall on either side
    assert float((cnt - cnt_r).abs().max()) <= 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e", [(LN, LE), (33, LE), (LN, 896), (33, 1664)])
def test_loss_backward_kernel(cuda, dt, n, e):
    """Widths above 768 take dx in column slabs: 896 = 768 + 128, 1664 = 768 +
    768 + 128 (the widest the kernels carry)."""
    lk, x, w, b, labels, rows = _loss_inputs(cuda, dt, n=n, seed=50 + n, e=e)
    m, s, _ = lk.softmax_stats_reference(x, w, b, labels)
    lse = m + torch.log(s)
    args = (x, w, b, lse, rows["u"], rows["cc"], rows["lt"], labels)
    dx, dz, parts = lk.sce_backward_tiles(*args)
    dx_r, dz_r, parts_r = lk.sce_backward_tiles_reference(*args)
    torch.cuda.synchronize()
    assert dz.dtype == dt and dx.dtype == torch.float32 and parts.shape == parts_r.shape
    err = (dz.float() - dz_r.float()).abs()
    ref = dz_r.float().abs()
    if dt == torch.bfloat16:
        assert float((err > 2.0 ** -7 * ref + 1e-9).float().mean()) < 1e-3
        assert bool((err <= 0.05 * ref + 1e-9).all()), float(err.max())
    else:
        assert bool((err <= 2e-5 * ref + 1e-9).all()), float(err.max())
    assert float(dz[8:16].float().abs().max()) == 0.0  # zero-weight rows give exactly 0
    torch.testing.assert_close(parts.sum(0), parts_r.sum(0), **STAT_TOL[dt])
    torch.testing.assert_close(dx, dx_r, **STAT_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_rce", [True, False])
def test_linear_sce_parts_kernel_route_matches_chunked_route(cuda, dt, with_rce):
    from vct_tpu_torch.ops import fused_loss as fl
    from vct_tpu_torch.ops import loss_kernels as lk

    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((LN, LE), generator=g).to(cuda)
    wg0 = (torch.randn((LV, LE), generator=g) / LE ** 0.5).to(cuda)
    bg0 = (torch.randn((LV,), generator=g) * 0.1).to(cuda)
    labels = torch.randint(0, LV, (LN,), generator=g).to(cuda)
    keep = (labels % 7 != 0).float()
    rect = (labels % 5 != 0).float()
    outs = []
    for use_kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x0, wg0, bg0)]
        before = [fn.launches for fn in lk.WRAPPERS]
        parts = fl.linear_sce_parts(*leaves, labels, keep, rect, dt, 512, with_rce,
                                    use_kernels)
        loss = 0.5 * parts[0] / parts[1] + 0.5 * parts[2] / parts[3].clamp(min=1.0)
        loss.backward()
        torch.cuda.synchronize()
        got = [fn.launches - b for fn, b in zip(lk.WRAPPERS, before)]
        assert got == ([1, int(with_rce), 1] if use_kernels else [0, 0, 0])
        outs.append(([p.detach() for p in parts], [t.grad for t in leaves]))
    tol = dict(rtol=1e-4, atol=1e-6) if dt == torch.float32 else dict(rtol=2e-2, atol=2e-4)
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e", [(LN, LE), (33, LE), (LN, 896)])
def test_loss_backward_kernel_on_the_bare_generator(cuda, dt, n, e):
    """The generator as the fused loss passes it (V = 1111 rows): the same
    results, bit for bit, as on its padded copy, and zeros past V."""
    lk, x, w, b, labels, rows = _loss_inputs(cuda, dt, n=n, seed=70 + n, e=e, padded=False)
    w_pad, b_pad = lk.pad_generator(w, b, dt)
    m, s, _ = lk.softmax_stats_reference(x, w, b, labels)
    lse = m + torch.log(s)
    vecs = (lse, rows["u"], rows["cc"], rows["lt"], labels)
    bare = lk.sce_backward_tiles(x, w, b, *vecs)
    padded = lk.sce_backward_tiles(x, w_pad, b_pad, *vecs)
    torch.cuda.synchronize()
    assert bare[1].shape == (n, 1536) and bare[2].shape[1] == 1536
    for a, p in zip(bare, padded):
        assert torch.equal(a, p)
    assert float(bare[1][:, LV:].float().abs().max()) == 0.0


STATS_N = [256, 1000, 1984, 4096]
STATS_V = [(1111, False), (3000, False), (30522, False), (30522, True)]  # True: padded to 30720


@pytest.mark.cuda
@pytest.mark.parametrize("e", [768, 896])
@pytest.mark.parametrize("v,padded", STATS_V)
@pytest.mark.parametrize("n", STATS_N)
def test_stats_kernels_against_plain_and_replaced_kernel(cuda, n, v, padded, e):
    """The bfloat16 statistics kernels (the tensor-core kernel) against their
    plain versions and against the kernel they replaced (route 0), with
    labels in the last partial vocab tile and outside [0, V); two calls give
    the same bits. Tolerances of ``chip_smoke.py`` (STAT_ATOL, ZT_ATOL)."""
    dt = torch.bfloat16
    lk, x, w, b, labels, _ = _loss_inputs(cuda, dt, n=n, seed=n + v, e=e, v=v, padded=padded)
    labels[4:7] = torch.tensor([-1, v, v + 700], dtype=torch.int32, device=cuda)
    m, s, zt = lk.softmax_stats(x, w, b, labels)
    again = lk.softmax_stats(x, w, b, labels)
    m_o, s_o, zt_o = lk._launch_softmax_stats(x, w, b, labels, _route=0)
    m_r, s_r, zt_r = lk.softmax_stats_reference(x, w, b, labels)
    lse = m_r + torch.log(s_r)
    sa, cnt = lk.clipped_prob_stats(x, w, b, lse)
    sa2, cnt2 = lk.clipped_prob_stats(x, w, b, lse)
    sa_o, cnt_o = lk._launch_clipped_prob_stats(x, w, b, lse, _route=0)
    sa_r, cnt_r = lk.clipped_prob_stats_reference(x, w, b, lse)
    torch.cuda.synchronize()
    for a, a2 in zip((m, s, zt, sa, cnt), (*again, sa2, cnt2)):
        assert torch.equal(a, a2)
    if not padded:
        assert float(zt[4:7].abs().max()) == 0.0
    for got in ((m, s, zt, sa, cnt), (m_o, s_o, zt_o, sa_o, cnt_o)):
        assert float((got[0] + torch.log(got[1]) - lse).abs().max()) <= 2e-3
        assert float((got[2] - zt_r).abs().max()) <= 0.04
        assert float((got[2] - zt_r).abs().mean()) <= 2e-3
        assert float((got[3] - sa_r).abs().max()) <= 2e-3
        assert float((got[4] - cnt_r).abs().max()) <= 8.0


@pytest.mark.cuda
def test_stats_plan_matches_the_launcher(cuda):
    from vct_tpu_torch.ops import loss_kernels as lk

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dt in (torch.float32, torch.bfloat16):
        for n in (1, 31, 256, 1984, 4096, 7936):
            for e in (128, 768, 896, 1664):
                for v in (1111, 30522, 30720):
                    for route in ((-1, 0, 1) if dt == torch.bfloat16 else (-1, 0)):
                        assert lk.sce_stats_plan(n, e, v, dt, route, sms) == _plan_from_library(
                            "vct_sce_stats_plan", lk._DTYPE_CODE[dt], n, e, v, route, sms, n=9)


@pytest.mark.cuda
def test_loss_wrappers_reject_bad_layouts(cuda):
    lk, x, w, b, labels, _ = _loss_inputs(cuda, torch.bfloat16)
    from vct_tpu_torch.ops._build import load_library

    assert load_library().vct_sce_block_rows(1) == lk.ROW_TILE[torch.bfloat16]
    assert load_library().vct_sce_block_rows(0) == lk.ROW_TILE[torch.float32]
    with pytest.raises(TypeError):
        lk.softmax_stats(x, w, b, labels.long())
    with pytest.raises(ValueError, match="expected"):   # a bias of another length
        lk.softmax_stats(x, w[:-1].contiguous(), b, labels)
    with pytest.raises(RuntimeError):   # float32 has no tensor-core route: the launcher refuses
        lk._launch_softmax_stats(x.float(), w.float(), b.float(), labels, _route=1)
    with pytest.raises(ValueError, match="is on cpu"):
        lk.clipped_prob_stats(x, w, b.cpu(), torch.zeros(LN, device=cuda))
    wide = torch.zeros((LN, lk.MAX_E_BF16 + 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        lk.softmax_stats(wide, torch.zeros((512, wide.shape[1]), dtype=torch.bfloat16,
                                           device=cuda), b[:512].contiguous(), labels)


# ---------------------------------------------------------------------------
# the fused attention kernels (csrc/attention.cu)
# ---------------------------------------------------------------------------
# float32: kernel and plain version differ by summation order only (2e-5 on
# outputs of magnitude ~1, 1e-4 of the largest gradient). bfloat16 forward:
# same rounding points, so outputs agree to one bfloat16 unit (2**-8
# relative; 0.02 absolute at magnitudes up to 2) and almost all exactly;
# bfloat16 backward: the kernel rounds P and dS to bfloat16 for the tensor
# cores where the plain version keeps them float32, so gradients agree to 2%
# of their largest value.

from vct_tpu_torch.ops import attention_kernels as ak  # noqa: E402

ATTN_SHAPES = [  # (B, Tq, Tk, H, D)
    (2, 31, 13, 2, 96), (2, 13, 13, 8, 96), (2, 8, 16, 4, 64), (1, 37, 200, 2, 128),
    (2, 128, 256, 2, 96), (3, 65, 130, 3, 16)]


def _attn_inputs(dev, dt, shape, bias_kind, rate, seed=0):
    b, tq, tk, h, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g).to(dev, dt)
                   for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d), (b, tq, h, d)))
    bias = None
    if bias_kind == "padding":
        bias = torch.zeros((b, 1, 1, tk))
        bias[:, :, :, tk - tk // 3:] = ak.NEG_INF
    elif bias_kind == "causal":
        bias = torch.where(torch.ones(tq, tk).tril().bool(), 0.0, ak.NEG_INF)[None, None]
    elif bias_kind == "rows":
        bias = torch.where(torch.ones(tq, tk).tril().bool(), 0.0, ak.NEG_INF)[None, None]
        bias = bias + torch.zeros((b, 1, 1, tk))
        bias[0, :, :, 1:3] = ak.NEG_INF
    elif bias_kind == "full":
        bias = torch.randn((b, h, tq, tk), generator=g)
        bias[0, 0, 0] = ak.NEG_INF  # a fully masked row: uniform over the keys
    keep = None
    if rate > 0:
        keep = (torch.rand((b, h, tq, tk), generator=g) >= rate).to(dev)
    return q, k, v, None if bias is None else bias.to(dev), keep, do


def _close(got, want, dt, grad=False):
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    if dt == torch.float32:
        assert float(err.max()) <= (1e-4 * scale if grad else 2e-5), float(err.max())
    elif grad:
        assert float(err.max()) <= 2e-2 * scale, (float(err.max()), scale)
    else:
        assert float(err.max()) <= 0.02 and float(err.mean()) <= 1e-3, \
            (float(err.max()), float(err.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_kind", [None, "padding", "causal", "rows", "full"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_kernels(cuda, dt, bias_kind, shape):
    if bias_kind in ("causal", "rows") and shape[1] != shape[2]:
        pytest.skip("square biases need Tq == Tk")
    for rate in (0.0, 0.3):
        q, k, v, bias, keep, do = _attn_inputs(cuda, dt, shape, bias_kind, rate)
        if rate == 0.0:
            before = ak.fused_attention.launches
            _close(ak.fused_attention(q, k, v, bias),
                   ak.fused_attention_reference(q, k, v, bias), dt)
            assert ak.fused_attention.launches == before + 1
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts = (ak.fused_attention_trainable.launches,
                  ak.fused_attention_trainable.backward_launches)
        out = ak.fused_attention_trainable(*leaves, bias, keep, rate)
        out.backward(do)
        torch.cuda.synchronize()
        assert (ak.fused_attention_trainable.launches,
                ak.fused_attention_trainable.backward_launches) == (counts[0] + 1,
                                                                    counts[1] + 1)
        _close(out, ak.fused_attention_trainable_reference(q, k, v, bias, keep, rate), dt)
        want = ak.fused_attention_backward_reference(q, k, v, bias, keep, rate, do)
        for got, ref in zip((t.grad for t in leaves), want):
            _close(got, ref, dt, grad=True)


@pytest.mark.cuda
def test_attention_kernel_reads_packed_qkv_in_place_and_repeats_its_bits(cuda):
    b, t, h, d = 2, 70, 4, 32
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn((b, t, 3 * h * d), generator=g).to(cuda, torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d) for i in range(3))
    assert not q.is_contiguous() and ak._strided(q) is q
    do = torch.randn((b, t, h, d), generator=g).to(cuda, torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ak.fused_attention_trainable(*leaves)
        out.backward(do)
        runs.append([out.detach()] + [x.grad for x in leaves])
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    _close(ak.fused_attention(q, k, v),
           ak.fused_attention_reference(q.contiguous(), k.contiguous(), v.contiguous()),
           torch.bfloat16)


@pytest.mark.cuda
def test_attention_wrapper_raises_outside_the_kernels_span(cuda):
    def mk(d, dt=torch.float32):
        return torch.zeros((1, 4, 2, d), device=cuda, dtype=dt)

    with pytest.raises(ValueError):
        ak.fused_attention(mk(100), mk(100), mk(100))
    with pytest.raises(ValueError):
        ak.fused_attention(mk(256), mk(256), mk(256))
    with pytest.raises(TypeError):
        ak.fused_attention(*(mk(64, torch.float16),) * 3)
    with pytest.raises(ValueError):  # a rate without a mask
        ak.fused_attention_trainable(mk(64), mk(64), mk(64), None, None, 0.3)


# ---------------------------------------------------------------------------
# the tensor-core generator + argmax (csrc/gen_argmax.cu) and the forward with
# its logits on chip (csrc/attention.cu, fwd_onchip_kernel)
# ---------------------------------------------------------------------------


def _plan_from_library(fn, *args, n):
    plan = _plan_or_none(fn, *args, n=n)
    assert plan is not None
    return plan


def _plan_or_none(fn, *args, n):
    """The launcher's plan, or None where it refuses the call."""
    import ctypes

    from vct_tpu_torch.ops._build import load_library

    out = (ctypes.c_int * n)()
    return None if getattr(load_library(), fn)(*args, out) else tuple(out)


def _gen_inputs(dev, dt, b, e, v, v_pad, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, e), generator=g) * 2).to(dev, dt)
    wg = torch.zeros((e, v_pad), device=dev, dtype=dt)
    wg[:, :v] = (torch.randn((e, v), generator=g) * 0.2).to(dev, dt)
    bg = torch.full((v_pad,), dk.NEG_INF, device=dev)
    bg[:v] = (torch.randn((v,), generator=g) * 0.1).to(dev)
    ns = (1 + 0.1 * torch.randn((e,), generator=g)).to(dev)
    nb = (0.1 * torch.randn((e,), generator=g)).to(dev)
    return x, ns, nb, wg, bg


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 7, 64, 65, 128, 200, 256])
def test_generator_argmax_routes(cuda, dt, b):
    """Every batch size on the route its dtype takes: vocab 1000 padded to
    1096 (not a multiple of the 256-column slab), width 136 (not a multiple
    of the 64-wide K step); no pad column wins; the same tokens twice."""
    e, v, v_pad = 136, 1000, 1096
    args = _gen_inputs(cuda, dt, b, e, v, v_pad, seed=b)
    plan = dk.gen_argmax_plan(b, e, v_pad, dt)
    assert plan.route == (1 if dt == torch.bfloat16 else 0)
    assert plan == _plan_from_library("vct_gen_argmax_plan", dk._DTYPE_CODE[dt], b, e, v_pad,
                                      -1, n=9)
    launches = dk.fused_norm_generator_argmax.launches
    tok = dk.fused_norm_generator_argmax(*args)
    again = dk.fused_norm_generator_argmax(*args)
    want = dk.fused_norm_generator_argmax_reference(*args)
    torch.cuda.synchronize()
    assert dk.fused_norm_generator_argmax.launches == launches + 2
    fw = {"norm_s": args[1], "norm_b": args[2], "wg": args[3], "bg": args[4]}
    _assert_tokens(tok, want, _gaps(args[0], fw))
    assert torch.equal(tok, again)
    assert int(tok.max()) < v and int(tok.min()) >= 0
    if dt == torch.bfloat16:  # the CUDA-core route on the same bfloat16 inputs
        _assert_tokens(dk._launch_gen_argmax(*args, _route=0), want, _gaps(args[0], fw))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 130])
def test_generator_argmax_tie_across_slabs_goes_to_the_lower_index(cuda, b):
    """Columns 100, 255, 256 and 900 (three slabs of 256 columns, and the two
    sides of a slab boundary) carry one weight column and lead the vocab: 100
    wins; without it 255 beats 256."""
    x, ns, nb, wg, bg = _gen_inputs(cuda, torch.bfloat16, b, 128, 1000, 1024, seed=11)
    assert dk.gen_argmax_plan(b, 128, 1024, torch.bfloat16).cols == 256
    for c in (255, 256, 900):
        wg[:, c] = wg[:, 100]
    bg[[100, 255, 256, 900]] = 1e3
    tok = dk.fused_norm_generator_argmax(x, ns, nb, wg, bg)
    assert tok.cpu().tolist() == [100] * b
    bg[100] = 0.0
    tok = dk.fused_norm_generator_argmax(x, ns, nb, wg, bg)
    assert tok.cpu().tolist() == [255] * b


@pytest.mark.cuda
def test_generator_argmax_rejects_bad_layouts(cuda):
    x, ns, nb, wg, bg = _gen_inputs(cuda, torch.bfloat16, 4, 128, 1000, 1024, seed=1)
    with pytest.raises(ValueError, match="is on cpu"):
        dk.fused_norm_generator_argmax(x, ns, nb.cpu(), wg, bg)
    with pytest.raises(TypeError):
        dk.fused_norm_generator_argmax(x, ns, nb, wg.float(), bg)
    with pytest.raises(TypeError):
        dk.fused_norm_generator_argmax(x.half(), ns, nb, wg.half(), bg)
    with pytest.raises(ValueError, match="multiples of 8"):
        dk.fused_norm_generator_argmax(x, ns, nb, wg[:, :1004].contiguous(), bg[:1004])
    with pytest.raises(RuntimeError):  # float32 has no tensor-core route: the launcher refuses
        dk._launch_gen_argmax(x.float(), ns, nb, wg.float(), bg, _route=1)


ONCHIP_SHAPES = [  # (B, Tq, Tk, H, D): ragged in both lengths, the three widths
    (2, 100, 100, 2, 96), (1, 70, 255, 3, 96), (2, 33, 257, 2, 16), (1, 129, 64, 2, 128),
    (1, 64, 704, 1, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", [0, 1])
@pytest.mark.parametrize("bias_kind", [None, "padding", "full"])
@pytest.mark.parametrize("shape", ONCHIP_SHAPES)
def test_attention_forward_routes(cuda, route, bias_kind, shape):
    """The bfloat16 forward on each route at the same shapes, with and without
    a keep mask, with the statistics the backward reads; two runs, one set of
    bits."""
    dt = torch.bfloat16
    for rate in (0.0, 0.3):
        q, k, v, bias, keep, _ = _attn_inputs(cuda, dt, shape, bias_kind, rate, seed=5)
        out, stats = ak._launch_forward(q, k, v, bias, keep, rate, True, route)
        again, stats2 = ak._launch_forward(q, k, v, bias, keep, rate, True, route)
        torch.cuda.synchronize()
        _close(out, ak.fused_attention_trainable_reference(q, k, v, bias, keep, rate), dt)
        assert torch.equal(out, again) and torch.equal(stats, stats2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * ak._scale(q)
        if bias is not None:
            logits = logits + bias
        m = logits.max(dim=-1).values
        l = torch.exp(logits - m[..., None]).sum(dim=-1)
        torch.testing.assert_close(stats[..., 0], m, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(stats[..., 1], l, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_attention_forward_plan_matches_the_launcher_and_its_boundary(cuda):
    for dt in (torch.float32, torch.bfloat16):
        for d in (16, 96, 128):
            for tk in (1, 100, 256, 704, 705, 768, 769, 1500):
                for has_keep in (False, True):
                    plan = ak.attention_forward_plan(tk, d, dt, has_keep)
                    assert plan == _plan_from_library(
                        "vct_attn_forward_plan", ak._DTYPE_CODE[dt], tk, d, int(has_keep), -1,
                        n=6), (dt, d, tk, has_keep)
    # past the on-chip limit the wrappers run the two-pass route, and asking
    # for the on-chip route there makes the launcher refuse before any launch
    shape = (1, 70, 800, 2, 96)
    q, k, v, bias, keep, do = _attn_inputs(cuda, torch.bfloat16, shape, "padding", 0.3, seed=2)
    assert ak.attention_forward_plan(800, 96, torch.bfloat16, True).route == 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ak.fused_attention_trainable(*leaves, bias, keep, 0.3)
    out.backward(do)
    _close(out, ak.fused_attention_trainable_reference(q, k, v, bias, keep, 0.3),
           torch.bfloat16)
    with pytest.raises(RuntimeError):
        ak._launch_forward(q, k, v, bias, keep, 0.3, True, 1)


# ---------------------------------------------------------------------------
# the backward with its products in registers (csrc/attention.cu,
# bwd_dq_onchip_kernel + bwd_dkv_onchip_kernel) and the tensor-core top-k
# (csrc/gen_topk.cu on gen_wgmma.cuh)
# ---------------------------------------------------------------------------

BWD_SHAPES = [  # (B, Tq, Tk, H, D): ragged in both lengths, the widths, Tk at the route's limit
    (2, 100, 100, 2, 96), (1, 70, 255, 3, 96), (2, 33, 257, 2, 16), (1, 129, 64, 2, 128),
    (1, 65, 320, 1, 96), (2, 128, 128, 2, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", [None, "padding", "rows", "full"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_attention_backward_routes(cuda, bias_kind, shape):
    """The bfloat16 backward on the new route (1) against the plain version
    and against the kernels it replaced (route 0), with and without a keep
    mask; ``full`` has a fully masked row; two runs, one set of bits."""
    if bias_kind == "rows" and shape[1] != shape[2]:
        pytest.skip("square biases need Tq == Tk")
    dt = torch.bfloat16
    assert ak.attention_backward_plan(shape[2], shape[4], dt, True).route == 1
    for rate in (0.0, 0.3):
        q, k, v, bias, keep, do = _attn_inputs(cuda, dt, shape, bias_kind, rate, seed=7)
        _, stats = ak._launch_forward(q, k, v, bias, keep, rate, True)
        new = ak._launch_backward(q, k, v, bias, keep, rate, do, stats, 1)
        again = ak._launch_backward(q, k, v, bias, keep, rate, do, stats, 1)
        old = ak._launch_backward(q, k, v, bias, keep, rate, do, stats, 0)
        want = ak.fused_attention_backward_reference(q, k, v, bias, keep, rate, do)
        torch.cuda.synchronize()
        for got, prev, ref, rep in zip(new, old, want, again):
            _close(got, ref, dt, grad=True)
            _close(got, prev, dt, grad=True)
            assert torch.equal(got, rep)


@pytest.mark.cuda
def test_attention_backward_plan_matches_the_launcher_and_its_boundary(cuda):
    for dt in (torch.float32, torch.bfloat16):
        for d in (16, 96, 128):
            for tk in (1, 100, 256, 320, 321, 576, 640, 641, 704, 705, 1500):
                for has_keep in (False, True):
                    plan = ak.attention_backward_plan(tk, d, dt, has_keep)
                    assert plan == _plan_from_library(
                        "vct_attn_backward_plan", ak._DTYPE_CODE[dt], tk, d, int(has_keep), -1,
                        n=7), (dt, d, tk, has_keep)
    assert ak.attention_backward_plan(320, 96, torch.bfloat16, True)[:2] == (1, 64)
    assert ak.attention_backward_plan(321, 96, torch.bfloat16, True).route == 0
    # past the limit the wrapper runs the replaced pair, and asking for the
    # new route there makes the launcher refuse before any launch
    shape = (1, 70, 321, 2, 96)
    q, k, v, bias, keep, do = _attn_inputs(cuda, torch.bfloat16, shape, "padding", 0.3, seed=2)
    _, stats = ak._launch_forward(q, k, v, bias, keep, 0.3, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ak.fused_attention_trainable(*leaves, bias, keep, 0.3).backward(do)
    want = ak.fused_attention_backward_reference(q, k, v, bias, keep, 0.3, do)
    for got, ref in zip((t.grad for t in leaves), want):
        _close(got, ref, torch.bfloat16, grad=True)
    with pytest.raises(RuntimeError):
        ak._launch_backward(q, k, v, bias, keep, 0.3, do, stats, 1)
    with pytest.raises(RuntimeError):  # float32 has no on-chip route
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        _, st32 = ak._launch_forward(q32, k32, v32, bias, keep, 0.3, True)
        ak._launch_backward(q32, k32, v32, bias, keep, 0.3, do32, st32, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 65, 128, 200, 256])
@pytest.mark.parametrize("k", [1, 4, dk.TOPK_MAX])
def test_generator_topk_routes(cuda, b, k):
    """bfloat16 on the tensor-core route at every batch tile size against the
    plain version and the replaced kernel (route 0): vocab 1000 padded to
    1096 (not a multiple of the 256-column slab), width 136 (not a multiple
    of the 64-wide K step); the same bits twice."""
    dt, e, v, v_pad = torch.bfloat16, 136, 1000, 1096
    args = _gen_inputs(cuda, dt, b, e, v, v_pad, seed=b + k)
    plan = dk.gen_topk_plan(b, e, v_pad, k, dt)
    assert plan.route == 1
    assert plan == _plan_from_library("vct_gen_topk_plan", 1, b, e, v_pad, k, -1, n=9)
    fw = {"norm_s": args[1], "norm_b": args[2], "wg": args[3], "bg": args[4]}
    launches = dk.fused_norm_generator_topk.launches
    got = dk.fused_norm_generator_topk(*args, k=k)
    again = dk.fused_norm_generator_topk(*args, k=k)
    old = dk._launch_gen_topk(*args, k, _route=0)
    want = dk.fused_norm_generator_topk_reference(*args, k=k)
    torch.cuda.synchronize()
    assert dk.fused_norm_generator_topk.launches == launches + 2
    for ref in (want, old):
        _assert_topk(got, ref, args[0], fw, dt, vocab=v)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 130])
def test_generator_topk_ties_across_slabs_on_the_tensor_core_route(cuda, b):
    """Columns 100, 255, 256 and 900 (three slabs of 256 columns, and the two
    sides of a slab boundary) carry one weight column and lead the vocab:
    they come out in ascending order with equal values."""
    x, ns, nb, wg, bg = _gen_inputs(cuda, torch.bfloat16, b, 128, 1000, 1024, seed=11)
    cols = [100, 255, 256, 900]
    for c in cols[1:]:
        wg[:, c] = wg[:, cols[0]]
    bg[cols] = 1e3
    v, i, _ = dk.fused_norm_generator_topk(x, ns, nb, wg, bg, k=4)
    assert i.cpu().tolist() == [cols] * b
    assert bool((v == v[:, :1]).all())


@pytest.mark.cuda
def test_topk_plan_matches_the_launcher(cuda):
    for dt in (torch.float32, torch.bfloat16):
        for b in (1, 64, 65, 256):
            for e, v in ((136, 1096), (768, 30720)):
                for k in (1, 4, 32):
                    for route in ((-1, 0, 1) if dt == torch.bfloat16 else (-1, 0)):
                        assert dk.gen_topk_plan(b, e, v, k, dt, route) == _plan_from_library(
                            "vct_gen_topk_plan", dk._DTYPE_CODE[dt], b, e, v, k, route, n=9)


# ---------------------------------------------------------------------------
# the tensor-core backward of the fused loss (csrc/sce_loss.cu) and the
# tensor-core stack step (csrc/stack_step.cu), bfloat16, against their plain
# versions and the kernels they replaced (route 0). Tolerances of
# chip_smoke.py: dz within one bfloat16 unit but in under 0.1% of the
# elements and within 5% everywhere; dx and dbg within 2% of their largest
# value; the stack's outputs as test_layers_step_kernel's.
# ---------------------------------------------------------------------------

# (N, E, V): the MSVD step, the long step, ragged row tiles, a width of dx
# tiles that ends half full (896), the widest width, small vocabularies
BWD_SHAPES = [(1984, 768, 30522), (4096, 768, 30522), (1000, 768, 30522), (300, 896, 3000),
              (33, 1664, 1111), (256, 768, 1111)]


def _assert_backward(got, want, zero_rows=True):
    dx, dz, parts = got
    dx_r, dz_r, parts_r = want
    assert dz.shape == dz_r.shape and parts.shape == parts_r.shape
    err = (dz.float() - dz_r.float()).abs()
    ref = dz_r.float().abs()
    assert float((err > 2.0 ** -7 * ref + 1e-12).float().mean()) < 1e-3
    assert bool((err <= 0.05 * ref + 1e-12).all()), float(err.max())
    if zero_rows:
        assert float(dz[8:16].float().abs().max()) == 0.0
    for a, r in ((dx, dx_r), (parts.sum(0), parts_r.sum(0))):
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= 2e-2 * scale + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,v", BWD_SHAPES)
def test_backward_tensor_core_route(cuda, n, e, v):
    """The plan takes the tensor-core route; it agrees with the plain version
    and with backward_kernel; labels outside [0, V) hit nothing; two calls
    give the same bits; the wrapper counts one launch a call."""
    dt = torch.bfloat16
    lk, x, w, b, labels, rows = _loss_inputs(cuda, dt, n=n, seed=90 + n, e=e, v=v,
                                             padded=False)
    labels[16:19] = torch.tensor([-1, v, v + 700], dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = lk.sce_backward_plan(n, e, v, dt, -1, sms)
    assert plan.route == 1
    m, s, _ = lk.softmax_stats_reference(x, w, b, labels)
    lse = m + torch.log(s)
    args = (x, w, b, lse, rows["u"], rows["cc"], rows["lt"], labels)
    before = lk.sce_backward_tiles.launches
    got = lk.sce_backward_tiles(*args)
    again = lk.sce_backward_tiles(*args)
    old = lk._launch_backward(*args, _route=0)
    want = lk.sce_backward_tiles_reference(*args)
    torch.cuda.synchronize()
    assert lk.sce_backward_tiles.launches == before + 2
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    assert float(got[1][:, v:].float().abs().sum()) == 0.0   # dz past V
    for ref in (want, old):
        _assert_backward(got, ref)


@pytest.mark.cuda
def test_backward_plan_matches_the_launcher(cuda):
    from vct_tpu_torch.ops import loss_kernels as lk

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dt in (torch.float32, torch.bfloat16):
        for n in (1, 33, 256, 1984, 4096, 7936, lk.BWD_MAX_N + 1):
            for e in (128, 768, 896, 1664):
                for v in (1111, 30522):
                    for route in (-1, 0, 1):
                        try:
                            plan = tuple(lk.sce_backward_plan(n, e, v, dt, route, sms))
                        except ValueError:
                            plan = None
                        assert plan == _plan_or_none("vct_sce_backward_plan", lk._DTYPE_CODE[dt],
                                                     n, e, v, route, sms, n=13), (dt, n, e, v, route)


def _stack_inputs(dev, b, e, heads, f, nl, idx, seed, big_l=32, tm=13):
    """Seeded stack-step inputs at the given widths, bfloat16, weights scaled
    by 1/sqrt(fan-in); caches filled below idx; a memory bias that masks the
    tail of odd rows."""
    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16

    def n(*s, scale=1.0, dtype=dt):
        return (torch.randn(s, generator=g) * scale).to(dev, dtype)

    w = {"wqkv": n(nl, e, 3 * e, scale=e ** -0.5), "bqkv": n(nl, 3 * e, scale=0.1),
         "wo": n(nl, e, e, scale=e ** -0.5), "bo": n(nl, e, scale=0.1),
         "wcq": n(nl, e, e, scale=e ** -0.5), "bcq": n(nl, e, scale=0.1),
         "wco": n(nl, e, e, scale=e ** -0.5), "bco": n(nl, e, scale=0.1),
         "w1": n(nl, e, f, scale=e ** -0.5), "b1": n(nl, f, scale=0.1),
         "w2": n(nl, f, e, scale=f ** -0.5), "b2": n(nl, e, scale=0.1)}
    for k in dk._NORM_KEYS:
        w[k] = (1 + n(nl, e, scale=0.1, dtype=torch.float32)) if k.endswith("s") \
            else n(nl, e, scale=0.1, dtype=torch.float32)
    kc, vc = n(nl, big_l, b, e), n(nl, big_l, b, e)
    kc[:, idx:] = 0
    vc[:, idx:] = 0
    mem_bias = torch.zeros((b, tm), device=dev)
    mem_bias[1::2, -4:] = dk.NEG_INF
    return w, (n(b, e), kc, vc, n(nl, tm, b, e), n(nl, tm, b, e), mem_bias)


# (E, heads, F, layers): the MSVD decoder, a width whose head (112) is not a
# power of two, and this file's small widths
STACK_WIDTHS = [(768, 8, 2048, 3), (896, 8, 2048, 1), (E, H, F, NL)]


@pytest.mark.cuda
@pytest.mark.parametrize("widths", STACK_WIDTHS)
@pytest.mark.parametrize("b", [65, 128, 256, 600])
def test_stack_tensor_core_route(cuda, b, widths):
    """fused_layers_step in bfloat16 takes the tensor-core kernel; x_out and
    the fresh cache rows agree with the plain version and with
    decode_step_kernel (route 0); two calls give the same bits."""
    e, heads, f, nl = widths
    assert dk.stack_step_plan(b, e, heads, f, torch.bfloat16).route == 1
    w, step = _stack_inputs(cuda, b, e, heads, f, nl, idx=12, seed=b + e)
    outs = []
    for fn in (lambda *s: dk.fused_layers_step(*s, w, 12, heads=heads, l_view=16)[0],
               lambda *s: dk.fused_layers_step(*s, w, 12, heads=heads, l_view=16)[0],
               lambda *s: dk._launch_layers_step(*s, w, 12, heads=heads, l_view=16, _route=0),
               lambda *s: dk.fused_layers_step_reference(*s, w, 12, heads=heads,
                                                          l_view=16)[0]):
        s = _clone(step)
        outs.append((fn(*s), s[1][:, 12].clone(), s[2][:, 12].clone()))
    torch.cuda.synchronize()
    for a, c in zip(outs[0], outs[1]):
        assert torch.equal(a, c)
    for ref in outs[2:]:
        for a, r in zip(outs[0], ref):
            torch.testing.assert_close(a.float(), r.float(), **TOL[torch.bfloat16])
            assert float((a.float() - r.float()).abs().mean()) < MEAN_BF16


@pytest.mark.cuda
def test_stack_tensor_core_route_window_poison(cuda):
    w, step = _stack_inputs(cuda, 65, E, H, F, NL, idx=16, seed=5)
    x, k_c, _, _, _, _ = s = _clone(step)
    out, _, _ = dk.fused_layers_step(*s, w, 16, heads=H, l_view=16)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out.float()).all())
    assert float(k_c[:, 16].float().abs().max()) > 0.0   # the row is written all the same


@pytest.mark.cuda
def test_stack_plan_matches_the_launcher(cuda):
    for dt in (torch.float32, torch.bfloat16):
        for b in (1, 64, 65, 256, dk.STACK_MAX_ROWS, dk.STACK_MAX_ROWS + 1):
            for e, heads, f in ((768, 8, 2048), (128, 4, 256), (96, 12, 256), (1280, 8, 2048),
                                (768, 2, 2048), (768, 3, 2048), (768, 8, 2560)):
                for route in (-1, 0, 1, 2):
                    try:
                        plan = tuple(dk.stack_step_plan(b, e, heads, f, dt, route))
                    except ValueError:
                        plan = None
                    assert plan == _plan_or_none("vct_stack_step_plan", dk._DTYPE_CODE[dt], b, e,
                                                 heads, f, route, n=7), (dt, b, e, heads, f, route)


# ---------------------------------------------------------------------------
# the small-row token path (csrc/small_step.cu), bfloat16 at 1-64 rows:
# fused_whole_step, fused_multi_step windows and fused_layers_step, against
# their plain versions and the kernels they replaced (route 0), at this
# file's widths and the MSVD decoder's
# ---------------------------------------------------------------------------

SMALL_WIDTHS = [(E, H, F, NL), (768, 8, 2048, 3)]


def _small_inputs(dev, b, widths, idx, seed):
    """bfloat16 stack and generator inputs at ``widths`` (a padded vocab of
    1024, the pad columns at NEG_INF), the embedding and position tables."""
    e, heads, f, nl = widths
    w, step = _stack_inputs(dev, b, e, heads, f, nl, idx=idx, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    wg = torch.zeros((e, V_PAD), device=dev, dtype=torch.bfloat16)
    wg[:, :V] = (torch.randn((e, V), generator=g) * e ** -0.5 * 4).to(dev, torch.bfloat16)
    bg = torch.full((V_PAD,), dk.NEG_INF, device=dev)
    bg[:V] = (torch.randn((V,), generator=g) * 0.1).to(dev)
    fw = {"stacked": w, "norm_s": 1 + (torch.randn((e,), generator=g) * 0.1).to(dev),
          "norm_b": (torch.randn((e,), generator=g) * 0.1).to(dev), "wg": wg, "bg": bg,
          "emb": (torch.randn((V, e), generator=g) * 0.5).to(dev, torch.bfloat16),
          "pe": (torch.randn((32, e), generator=g) * 0.5).to(dev, torch.bfloat16),
          "heads": heads}
    return fw, step


@pytest.mark.cuda
@pytest.mark.parametrize("widths", SMALL_WIDTHS)
@pytest.mark.parametrize("b", [1, 7, 32, 64])
def test_whole_step_small_row_route(cuda, b, widths):
    """fused_whole_step takes the small-row kernel: tokens against the plain
    version and decode_step_kernel (route 0) but at near-ties, cache rows
    within the bfloat16 tolerance; two calls give the same bits; the stack a
    beam runs at these rows with the top-k kernel at k=1, and the argmax
    kernel, give its tokens bit for bit; tokens -1 when idx >= l_view."""
    e, heads, f, _ = widths
    assert dk.whole_step_plan(b, e, heads, f, V_PAD, torch.bfloat16).route == 1
    assert dk.stack_step_plan(b, e, heads, f, torch.bfloat16).route == 2
    idx, l_view = 12, 16
    fw, step = _small_inputs(cuda, b, widths, idx, seed=b + e)
    outs = []
    for route in (-1, -1, 0):
        s = _clone(step)
        tok = dk._launch_whole_step(*s, fw, idx, heads=heads, l_view=l_view, _route=route)
        outs.append((tok, s[1][:, idx].clone(), s[2][:, idx].clone()))
    s = _clone(step)
    x_r = dk._stack_reference(*s, fw["stacked"], idx, heads, l_view)
    tok_r = dk.fused_norm_generator_argmax_reference(x_r, fw["norm_s"], fw["norm_b"], fw["wg"],
                                                     fw["bg"])
    s = _clone(step)
    xs, _, _ = dk.fused_layers_step(*s, fw["stacked"], idx, heads=heads, l_view=l_view)
    gargs = (xs, fw["norm_s"], fw["norm_b"], fw["wg"], fw["bg"])
    top1 = dk.fused_norm_generator_topk(*gargs, k=1)[1][:, 0]
    arg = dk.fused_norm_generator_argmax(*gargs)
    torch.cuda.synchronize()
    for a, c in zip(outs[0], outs[1]):
        assert torch.equal(a, c)
    assert torch.equal(top1, outs[0][0]) and torch.equal(arg, outs[0][0])
    assert torch.equal(s[1][:, idx], outs[0][1])
    gaps = _gaps(x_r, fw)
    for want in (tok_r, outs[2][0]):
        _assert_tokens(outs[0][0], want, gaps)
    for want in ((s[1][:, idx], s[2][:, idx]), outs[2][1:]):
        for a, r in zip(outs[0][1:], want):
            torch.testing.assert_close(a.float(), r.float(), **TOL[torch.bfloat16])
    s = _clone(step)
    poisoned, _, _ = dk.fused_whole_step(*s, fw, 16, heads=heads, l_view=16)
    torch.cuda.synchronize()
    assert bool((poisoned == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("widths", SMALL_WIDTHS)
@pytest.mark.parametrize("b", [1, 7, 32, 64])
def test_multi_step_small_row_route(cuda, b, widths):
    """Windows of u=2 and 4 on the small-row kernel: the per-token whole step
    along the window's chain gives its tokens and cache rows bit for bit; the
    same bits twice; both routes' window poison. At this file's widths the
    chain is also held to the plain version and to decode_multi_kernel
    (route 0) but at near-ties. At the MSVD widths these weights put the
    plain version's float32 sums and both kernels' (the replaced one too)
    near-ties a little past NEAR_TIE apart, the noise floor that ROADMAP.md
    §3 names; chip_smoke.py holds the MSVD model's chains there."""
    e, heads, f, _ = widths
    assert dk.multi_step_plan(b, e, heads, f, V_PAD, torch.bfloat16).route == 1
    fw, (_, kc, vc, ck, cv, mb) = _small_inputs(cuda, b, widths, 0, seed=50 + b + e)
    emb, pe = fw["emb"], fw["pe"]
    start = torch.full((b,), 101, dtype=torch.int32, device=cuda)
    start[0] = 0
    for u in (2, 4):
        l_view = 8
        runs = []
        for route in (-1, -1, 0):
            ks, vs = kc.clone(), vc.clone()
            tok = torch.empty((b, u), dtype=torch.int32, device=cuda)
            dk._launch_multi(start, ks, vs, ck, cv, mb, emb, pe, fw, heads=heads, l_view=l_view,
                             i0=u, n_tok=u, seq=False, poison=False, tok_out=tok, start_id=0,
                             end_id=-1, pad_id=0, route=route)
            runs.append((tok, ks, vs))
        ks, vs, ks_r, vs_r = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        c, c_r, chain, gaps, plain = start, start, [], [], []
        for j in range(u):
            pos = u + j
            c = dk.fused_whole_step(dk._embed_step(emb, pe, c, pos, 0), ks, vs, ck, cv, mb, fw,
                                    pos, heads=heads, l_view=l_view)[0]
            chain.append(c)
            c = runs[0][0][:, j].contiguous()
            xs = dk._stack_reference(dk._embed_step(emb, pe, c_r, pos, 0), ks_r, vs_r, ck, cv,
                                     mb, fw["stacked"], pos, heads, l_view)
            gaps.append(_gaps(xs, fw))
            c_r = dk.fused_norm_generator_argmax_reference(xs, fw["norm_s"], fw["norm_b"],
                                                           fw["wg"], fw["bg"])
            plain.append(c_r)
        torch.cuda.synchronize()
        for a, r in zip(runs[0], runs[1]):
            assert torch.equal(a, r)
        assert torch.equal(torch.stack(chain, 1), runs[0][0])
        assert torch.equal(ks, runs[0][1]) and torch.equal(vs, runs[0][2])
        gap_w = torch.stack(gaps, dim=1)
        for want in (torch.stack(plain, 1), runs[2][0]) if e == E else ():
            _assert_chain(runs[0][0], want, lambda r: gap_w[r])
    for route in (-1, 0):
        tok = torch.empty((b, 4), dtype=torch.int32, device=cuda)
        dk._launch_multi(start, kc.clone(), vc.clone(), ck, cv, mb, emb, pe, fw, heads=heads,
                         l_view=8, i0=8, n_tok=4, seq=False, poison=True, tok_out=tok,
                         start_id=0, end_id=-1, pad_id=0, route=route)
        torch.cuda.synchronize()
        assert bool((tok == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32, 64, 65])
def test_greedy_modes_and_a_beam_of_one_give_the_same_tokens(cuda, b):
    """At the MSVD widths, 29 tokens: the per-token greedy loop, windows of
    u=2 and 4 (at 64 rows and fewer) and a beam of 1 give the same tokens
    bit for bit, on both sides of the 64/65 boundary."""
    from vct_tpu_torch.decode_fast import _beam_loop, _decode_loop

    widths = (768, 8, 2048, 3)
    fw, (_, _, _, ck, cv, mb) = _small_inputs(cuda, b, widths, 0, seed=900 + b)
    kw = dict(max_len=30, start_id=101, end_id=-1, pad_id=0)
    base = _decode_loop(fw, ck, cv, mb, single_kernel=b <= 64, **kw)
    beam, _ = _beam_loop(fw, ck, cv, mb, beam_size=1, length_penalty=0.6, **kw)
    torch.cuda.synchronize()
    assert torch.equal(beam, base)
    if b > dk.SMALL_MAX_ROWS:
        return
    for u in (2, 4):
        ks = torch.zeros((3, 32, b, 768), dtype=torch.bfloat16, device=cuda)
        vs = torch.zeros_like(ks)
        cur = base[:, 0].contiguous()
        got = [base[:, :1]]
        for w in range(32 // u):
            toks, _, _ = dk.fused_multi_step(cur, ks, vs, ck, cv, mb, fw["emb"], fw["pe"], fw, w,
                                             heads=8, unroll=u, pad_id=0, l_view=32)
            got.append(toks)
            cur = toks[:, -1].contiguous()
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(got, 1)[:, :30], base)


@pytest.mark.cuda
def test_small_plans_match_the_launcher(cuda):
    for entry, fn in (("vct_whole_step_plan", dk.whole_step_plan),
                      ("vct_multi_step_plan", dk.multi_step_plan),
                      ("vct_sequence_decode_plan", dk.sequence_decode_plan)):
        for dt in (torch.float32, torch.bfloat16):
            for b in (1, 7, 32, 33, 64, 65):
                for e, heads, f in ((768, 8, 2048), (128, 4, 256), (96, 12, 256),
                                    (1280, 8, 2048), (768, 2, 2048), (768, 8, 2560)):
                    for v in (V_PAD, 1020):
                        for route in (-1, 0, 1):
                            try:
                                plan = tuple(fn(b, e, heads, f, v, dt, route))
                            except ValueError:
                                plan = None
                            assert plan == _plan_or_none(entry, dk._DTYPE_CODE[dt], b, e, heads,
                                                         f, v, route, n=7), (entry, dt, b, e, f)


# ---------------------------------------------------------------------------
# fused_sequence_decode and fused_layer_step on the tensor-core token paths:
# the sequence kernel in bfloat16 at 1-32 rows is the small-row kernel's
# token in a loop, fused_layer_step the stack's launch at NL = 1, so both give
# the per-token loop's and the stack's bits
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("widths", SMALL_WIDTHS)
@pytest.mark.parametrize("b", [1, 7, 32])
def test_sequence_decode_small_row_route(cuda, b, widths):
    """The bf16 sequence kernel gives the per-token greedy loop's tokens bit
    for bit: free running, with an end token that stops some rows (all at
    B=1, so the kernel leaves its loop early), and with every row stopping at
    step 1 (the pad fill). Two calls give the same bits; decode_multi_kernel
    (route 0) stays reachable, and at this file's widths parts from the
    chain only at near-ties."""
    from vct_tpu_torch.decode_fast import _decode_loop

    e, heads, f, _ = widths
    assert dk.sequence_decode_plan(b, e, heads, f, V_PAD, torch.bfloat16).route == 1
    fw, (_, _, _, ck, cv, mb) = _small_inputs(cuda, b, widths, 0, seed=70 + b + e)
    kw = dict(max_len=30, start_id=101, pad_id=0)
    free = _decode_loop(fw, ck, cv, mb, end_id=-1, single_kernel=True, **kw)
    biased = dict(fw, bg=fw["bg"].clone())
    biased["bg"][5] = 1e3
    launches = dk.fused_sequence_decode.launches
    for w, end_id in ((fw, -1), (fw, int(free[0, 3])), (biased, 5)):
        base = _decode_loop(w, ck, cv, mb, end_id=end_id, single_kernel=True, **kw)
        sargs = (w["emb"], w["pe"], ck, cv, mb, w)
        got = [dk.fused_sequence_decode(*sargs, heads=heads, end_id=end_id, **kw)
               for _ in range(2)]
        old = dk._launch_sequence_decode(*sargs, heads=heads, end_id=end_id, _route=0, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1]) and torch.equal(got[0], base), (end_id, got[0], base)
        assert old.shape == (b, 30) and bool((old[:, 0] == 101).all())
        if end_id == 5:
            assert base.tolist() == old.tolist() == [[101, 5] + [0] * 28] * b
            continue
        if end_id >= 0 and b == 1:   # the only row is done: the pad fill from position 4
            assert bool((base[0, 4:] == 0).all())
        if e == E:
            nl = ck.shape[0]
            ks = torch.zeros((nl, 32, b, e), dtype=torch.bfloat16, device=cuda)
            vs = torch.zeros_like(ks)
            gaps = []
            for i in range(29):
                x = dk._embed_step(w["emb"], w["pe"], base[:, i], i, 0)
                gaps.append(_gaps(dk._stack_reference(x, ks, vs, ck, cv, mb, w["stacked"], i,
                                                      heads, 32), w))
            gaps = torch.stack(gaps, dim=1)
            _assert_chain(old[:, 1:], base[:, 1:], lambda r: gaps[r])
    assert dk.fused_sequence_decode.launches == launches + 6


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [STACK_WIDTHS[2], SMALL_WIDTHS[1]])
@pytest.mark.parametrize("b", [1, 32, 64, 65, 256])
def test_layer_step_takes_the_stack_routes(cuda, b, widths):
    """fused_layer_step in bfloat16 is the stack's launch at NL = 1: the
    small-row kernel at 1-64 rows, stack_step_kernel at 65-256. Each layer
    equals fused_layers_step at NL = 1 bit for bit, twice the same bits; run
    layer by layer (decode_fast.layers_step_per_layer, on the stack's layer
    views) it equals the stack; decode_step_kernel (route 0) stays reachable
    and within the bf16 tolerance of the plain version; an idx past the cache
    is refused on every route."""
    from vct_tpu_torch.decode_fast import layers_step_per_layer

    e, heads, f, nl = widths
    assert dk.stack_step_plan(b, e, heads, f, torch.bfloat16).route == (2 if b <= 64 else 1)
    w, (x, kc, vc, ck, cv, mb) = _stack_inputs(cuda, b, e, heads, f, nl, idx=12,
                                               seed=600 + b + e)
    launches = dk.fused_layer_step.launches
    for li in range(nl):
        one = {k: v[li:li + 1] for k, v in w.items()}
        layer = {k: v[li] for k, v in w.items()}
        k1, v1 = kc[li:li + 1].clone(), vc[li:li + 1].clone()
        want, _, _ = dk.fused_layers_step(x, k1, v1, ck[li:li + 1], cv[li:li + 1], mb, one, 12,
                                          heads=heads)
        runs = []
        for _ in range(2):
            k2, v2 = kc[li].clone(), vc[li].clone()
            out, _, _ = dk.fused_layer_step(x, k2, v2, ck[li], cv[li], mb, layer, 12,
                                            heads=heads)
            runs.append((out, k2, v2))
        k3, v3 = kc[li].clone(), vc[li].clone()
        old = dk._launch_layer_step(x, k3, v3, ck[li], cv[li], mb, layer, 12, heads=heads,
                                    _route=0)
        k4, v4 = kc[li].clone(), vc[li].clone()
        ref, _, _ = dk.fused_layer_step_reference(x, k4, v4, ck[li], cv[li], mb, layer, 12,
                                                  heads=heads)
        torch.cuda.synchronize()
        for a, c in zip(runs[0], runs[1]):
            assert torch.equal(a, c)
        out, k2, v2 = runs[0]
        assert torch.equal(out, want) and torch.equal(k2, k1[0]) and torch.equal(v2, v1[0])
        for got, r in ((out, ref), (k2[12], k4[12]), (old, ref), (k3[12], k4[12])):
            torch.testing.assert_close(got.float(), r.float(), **TOL[torch.bfloat16])
    assert dk.fused_layer_step.launches == launches + 2 * nl
    ks, vs, ks2, vs2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    stack, _, _ = dk.fused_layers_step(x, ks, vs, ck, cv, mb, w, 12, heads=heads)
    per, _, _ = layers_step_per_layer(x, ks2, vs2, ck, cv, mb, w, 12, heads=heads)
    torch.cuda.synchronize()
    assert torch.equal(per, stack) and torch.equal(ks2, ks) and torch.equal(vs2, vs)
    layer = {k: v[0] for k, v in w.items()}
    for route in (-1, 0, 1, 2) if b <= 64 else (-1, 0, 1):
        with pytest.raises(ValueError, match="no row"):
            dk._launch_layer_step(x, kc[0].clone(), vc[0].clone(), ck[0], cv[0], mb, layer,
                                  kc.shape[1], heads=heads, _route=route)
    with pytest.raises(ValueError, match="no row"):
        dk.fused_layer_step(x, kc[0].clone(), vc[0].clone(), ck[0], cv[0], mb, layer,
                            kc.shape[1], heads=heads)


# ---------------------------------------------------------------------------
# the I3D tower (cuDNN convolutions, float32 with TF32 off)
# ---------------------------------------------------------------------------


def _seeded_i3d(in_channels, device):
    from vct_tpu_torch.i3d import I3DTower

    tower = I3DTower(in_channels)
    g = torch.Generator().manual_seed(in_channels)
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if name.endswith("scale"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return tower.eval().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("in_channels", [3, 2])
def test_i3d_tower_on_the_card_equals_the_cpu(cuda, in_channels):
    """The tower at (1, 9, 200, 200, C) on the card against its CPU run,
    float32 at rtol = atol = 2e-4 (the CPU tests' bound against vct_tpu)."""
    x = torch.rand((1, 9, 200, 200, in_channels), generator=torch.Generator().manual_seed(1))
    x = x * 2 - 1
    with torch.no_grad():
        want = _seeded_i3d(in_channels, torch.device("cpu"))(x)
        got = _seeded_i3d(in_channels, cuda)(x.to(cuda))
    assert got.dtype == torch.float32 and got.shape == (1, 1024)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_i3d_tower_runs_float32_with_the_global_tf32_switch_on(cuda):
    """cuDNN runs a float32 conv3d in TF32 while ``cudnn.allow_tf32`` is on
    (torch's default); the tower switches it off for its own forward. Against
    float64 on the card its features part by under 2e-5 of the largest, and
    the switch is as the caller left it afterwards."""
    import copy

    tower = _seeded_i3d(3, cuda)
    x = (torch.rand((1, 9, 200, 200, 3), generator=torch.Generator().manual_seed(2)) * 2
         - 1).to(cuda)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got, again = tower(x), tower(x)
            want = copy.deepcopy(tower).double()(x.double())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert torch.equal(got, again)
    rel = (got.double() - want).abs().max() / want.abs().max()
    assert rel < 2e-5, rel


# ---------------------------------------------------------------------------
# the compiled decode programs: CUDA graphs of the staged kernel loops
# (graphs.StagedDecode), encoder included, against the eager loops
# ---------------------------------------------------------------------------


def _graph_model(dev, dt, seed=0):
    """A seeded captioner at this file's widths (MME encoder over 64-wide
    features, 2 decoder layers, vocab 600), on the card in ``dt``."""
    from vct_tpu_torch.config import ModelConfig, TPUConfig
    from vct_tpu_torch.models.mmt4caption import MMT4Caption

    cfg = ModelConfig.from_dict({
        "modal": ["m0"], "modal_shape": [64], "embed_dim": E, "dropout": 0.0,
        "vocab_size": V, "activation": "gelu",
        "video_encoder": {"layer": 1, "nhead": H, "feedforward": F},
        "caption_decoder": {"layer": NL, "nhead": H, "feedforward": F}})
    model = MMT4Caption(cfg, TPUConfig(dtype="float32" if dt == torch.float32 else "bfloat16"),
                        dtype=dt, device=dev)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.eval().to_compute_dtype()


def _video_batch(dev, b, seed, t=12):
    g = torch.Generator().manual_seed(seed)
    masks = torch.zeros((b, t), dtype=torch.bool)
    masks[1::3, t // 2:] = True
    return [torch.randn((b, t, 64), generator=g).to(dev)], [masks.to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 64, 128])
def test_graphed_greedy_is_the_eager_loop_bit_for_bit(cuda, dt, b):
    """``make_fused_greedy_fn`` on the card: the first call of a shape (the
    eager stages on a side stream, then the capture) and two replays give
    ``greedy_generate_fused``'s tokens bit for bit, running free and with
    row 0's fourth token as the end token; one set of graphs per shape, and
    the replays add the captured launches to the wrappers' counts."""
    from vct_tpu_torch.decode_fast import greedy_generate_fused, make_fused_greedy_fn

    model = _graph_model(cuda, dt)
    feats, masks = _video_batch(cuda, b, seed=b)
    kw = dict(max_len=30, start_id=101)
    free, _ = greedy_generate_fused(model, feats, masks, end_id=-1, **kw)
    counted = dk.fused_whole_step if b <= 64 else dk.fused_layers_step
    for end_id in (-1, int(free[0, 3])):
        want, _ = greedy_generate_fused(model, feats, masks, end_id=end_id, **kw)
        fn = make_fused_greedy_fn(model, 30, 101, end_id)
        for call in range(3):
            before = counted.launches
            got, _ = fn(feats, masks)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (end_id, call)
            # one launch a token, up to the stage at which every row is done
            assert counted.launches - before in ((29,) if end_id == -1 else (8, 16, 24, 29))
        assert (fn.sets, fn.graphs) == (1, 4)
        assert fn.replays == 8 if end_id == -1 else fn.replays in (2, 4, 6, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_graphed_beam_is_the_eager_loop_bit_for_bit(cuda, dt):
    """``make_fused_beam_fn`` (beam 4 over 16 videos, 64 rows) gives
    ``beam_generate_fused``'s tokens and scores bit for bit, first call and
    replays; a result held across a call is not overwritten."""
    from vct_tpu_torch.decode_fast import beam_generate_fused, make_fused_beam_fn

    model = _graph_model(cuda, dt, seed=1)
    feats, masks = _video_batch(cuda, 16, seed=5)
    want_t, want_s = beam_generate_fused(model, feats, masks, beam_size=4, max_len=30,
                                         start_id=101, end_id=-1)
    fn = make_fused_beam_fn(model, 30, 101, -1, 4)
    results = [fn(feats, masks) for _ in range(3)]
    torch.cuda.synchronize()
    for got_t, got_s in results:
        assert torch.equal(got_t, want_t) and torch.equal(got_s, want_s)
    assert (fn.sets, fn.graphs, fn.replays) == (1, 4, 8)


@pytest.mark.cuda
def test_capture_on_a_worker_thread_while_another_thread_works(cuda):
    """The graphs are captured in thread-local mode: a capture on one thread
    is not broken by another thread that launches work and waits for the
    device meanwhile (the server's handler threads run the CLIP tower while
    its batcher decodes)."""
    import threading

    from vct_tpu_torch.decode_fast import greedy_generate_fused, make_fused_greedy_fn

    model = _graph_model(cuda, torch.bfloat16, seed=2)
    feats, masks = _video_batch(cuda, 8, seed=9)
    want, _ = greedy_generate_fused(model, feats, masks, max_len=30, start_id=101, end_id=-1)
    fn = make_fused_greedy_fn(model, 30, 101, -1)
    stop, busy, out, errors = threading.Event(), [0], {}, []

    def other():
        x = torch.randn((512, 512), device=cuda)
        while not stop.is_set():
            x = torch.tanh(x @ x)
            float(x.sum())  # waits for the device
            busy[0] += 1

    def decode():
        try:
            out["first"] = fn(feats, masks)[0]
            out["replay"] = fn(feats, masks)[0]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - read below, on the test's thread
            errors.append(e)

    worker, decoder = threading.Thread(target=other), threading.Thread(target=decode)
    worker.start()
    decoder.start()
    decoder.join(timeout=300)
    stop.set()
    worker.join(timeout=60)
    assert not decoder.is_alive() and not worker.is_alive() and not errors, errors
    assert busy[0] > 0 and fn.graphs == 4
    assert torch.equal(out["first"], want) and torch.equal(out["replay"], want)


@pytest.mark.cuda
def test_auto_dispatch_replays_graphs_on_the_card(cuda):
    """``make_auto_greedy_fn`` / ``make_auto_beam_fn`` on CUDA tensors take the
    graph route: their runner captured and replayed, and a result held across
    two replays into the same buffers keeps its tokens."""
    from vct_tpu_torch.decode import make_auto_beam_fn, make_auto_greedy_fn

    model = _graph_model(cuda, torch.bfloat16, seed=3)
    batch_a, batch_b = _video_batch(cuda, 4, seed=11), _video_batch(cuda, 4, seed=12)
    for fn in (make_auto_greedy_fn(model, 30, 101, -1), make_auto_beam_fn(model, 30, 101, -1, 2)):
        first = fn(*batch_a)[0]
        kept = first.clone()
        again, other = fn(*batch_a)[0], fn(*batch_b)[0]  # replays into the same buffers
        torch.cuda.synchronize()
        assert torch.equal(first, kept) and torch.equal(again, kept)
        assert not torch.equal(other, kept)
        assert fn.runner.sets == 1 and fn.runner.graphs == 4 and fn.runner.replays == 8


# ---------------------------------------------------------------------------
# the compiled train and validation steps: CUDA graphs of the whole step
# (train.step.GraphedTrainStep / GraphedEvalStep) against the eager steps
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_V = 16, 17, 1100   # 256 loss rows: the loss kernels' route


def _train_state(dev, name, seed=0):
    """A seeded captioner at this file's widths with dropout 0.3, bf16, the
    loss kernels on, and its optimizer (``name``) and dropout generator as the
    Trainer builds them."""
    from vct_tpu_torch.config import ModelConfig, TPUConfig, TrainConfig
    from vct_tpu_torch.models.mmt4caption import MMT4Caption
    from vct_tpu_torch.train.optimizers import build_optimizer
    from vct_tpu_torch.train.state import make_train_state

    cfg = ModelConfig.from_dict({
        "modal": ["m0"], "modal_shape": [64], "embed_dim": E, "dropout": 0.3,
        "vocab_size": TRAIN_V, "activation": "gelu",
        "video_encoder": {"layer": 1, "nhead": H, "feedforward": F},
        "caption_decoder": {"layer": NL, "nhead": H, "feedforward": F}})
    model = MMT4Caption(cfg, TPUConfig(dtype="bfloat16", use_fused_loss=True,
                                       fused_loss_pallas=True), dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = {"adam": {}, "adamw": {"weight_decay": 0.01}, "sgd": {"momentum": 0.9}}[name]
    train = TrainConfig.from_dict({"task": "caption", "optimizer": {
        "name": name, "learning_rate": 1e-3, "beta": [0.9, 0.999], **opt}})
    return make_train_state(model, build_optimizer(train, model), device=dev, seed=5)


def _train_batch(dev, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((TRAIN_B, TRAIN_S), dtype=torch.int32)
    for r in range(TRAIN_B):
        n = int(torch.randint(3, TRAIN_S - 2, (1,), generator=g))
        ids[r, 0], ids[r, n + 1] = 2, 3
        ids[r, 1:n + 1] = torch.randint(5, TRAIN_V, (n,), generator=g)
    masks = torch.zeros((TRAIN_B, 12), dtype=torch.bool)
    masks[1::3, 8:] = True
    valid = torch.arange(TRAIN_B) < TRAIN_B - 2
    return {"feats": [torch.randn((TRAIN_B, 12, 64), generator=g).to(dev)],
            "masks": [masks.to(dev)], "token_ids": ids.to(dev),
            "token_mask": (ids == 0).to(dev), "row_valid": valid.to(dev)}


def _state_tensors(state, metrics):
    out = {f"metric {k}": v for k, v in metrics.items()}
    names = {id(p): k for k, p in state.model.named_parameters()}
    out.update({k: p.detach() for k, p in state.model.named_parameters()})
    for p, st in state.optimizer.state.items():
        out.update({f"{names[id(p)]} {k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    out["generator"] = state.generator.get_state()
    return out


def _hold_to_eager(got, want, again):
    """Bit for bit where the eager step repeated itself bit for bit; within
    its own spread where it did not (``chip_smoke.py`` phase 22's rule)."""
    def parted(a, b):
        return {k: float((a[k].double() - b[k].double()).abs().max())
                for k in a if not torch.equal(a[k], b[k])}

    own = parted(want, again)
    for k, d in parted(got, want).items():
        assert k in own and d <= own[k], (k, d, own.get(k))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_graphed_train_steps_equal_eager_steps(cuda, name, tmp_path):
    """Six steps: the graphed runner's first call (eager on a side stream,
    then the capture) and five replays against the eager step on two copies
    of the same state, with the LR cut before step 4 (filled in place: the
    replays read it) and, after step 3, a save and a restore into a fresh
    state whose runner captures again; every parameter, the optimizer state,
    the generator state and the metrics after each step. The replays add the
    loss kernels' launches, three a step."""
    from vct_tpu_torch.ops import loss_kernels as lk
    from vct_tpu_torch.train.optimizers import set_learning_rate
    from vct_tpu_torch.train.state import restore_checkpoint, save_checkpoint
    from vct_tpu_torch.train.step import make_train_step

    eager_a, eager_b, graphed = (_train_state(cuda, name) for _ in range(3))
    runner, resumed_runner = make_train_step("caption"), make_train_step("caption")
    resumed = None
    batches = [_train_batch(cuda, s) for s in range(3)]
    for i in range(6):
        if i == 3:
            for st in (eager_a, eager_b, graphed):
                set_learning_rate(st.optimizer, 3e-4)
            save_checkpoint(str(tmp_path / "state.pt"), graphed)
            resumed = _train_state(cuda, name, seed=1)  # other weights, all restored
            restore_checkpoint(str(tmp_path / "state.pt"), resumed)
            set_learning_rate(resumed.optimizer, 3e-4)
        batch = batches[i % 3]
        want = _state_tensors(eager_a, runner.eager(eager_a, batch)[1])
        again = _state_tensors(eager_b, runner.eager(eager_b, batch)[1])
        before = lk.softmax_stats.launches
        _, metrics = runner(graphed, batch)
        torch.cuda.synchronize()
        assert lk.softmax_stats.launches - before == 1
        _hold_to_eager(_state_tensors(graphed, metrics), want, again)
        if resumed is not None:
            _hold_to_eager(_state_tensors(resumed, resumed_runner(resumed, batch)[1]),
                           want, again)
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 5)
    assert (resumed_runner.sets, resumed_runner.replays) == (1, 2)
    assert graphed.step == eager_a.step == resumed.step == 6


@pytest.mark.cuda
def test_graphed_eval_step_equals_eager(cuda):
    from vct_tpu_torch.train.step import make_eval_step

    state = _train_state(cuda, "adam")
    batch = _train_batch(cuda, 7)
    runner = make_eval_step("caption")
    want = runner.eager(state.model, batch)
    held = [runner(state.model, batch) for _ in range(3)]
    torch.cuda.synchronize()
    for got in held:
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 2)
    assert held[1]["ce_sum"].data_ptr() != held[2]["ce_sum"].data_ptr()


# ---------------------------------------------------------------------------
# the CLIP towers' compiled programs: the graphed towers (graphs.StagedModule)
# and the pixels-to-tokens program (pipeline.make_video_caption_fn) against
# their eager runs
# ---------------------------------------------------------------------------


def _towers(dev):
    """Seeded small CLIP towers on the card: vision (width 128, 2 layers, 64
    out, as ``_graph_model``'s features) and text (width 128, 2 layers,
    vocab 1000)."""
    from vct_tpu_torch.clip.text import CLIPTextTower
    from vct_tpu_torch.clip.vision import CLIPVisionTower, init_clip_weights

    vision = init_clip_weights(CLIPVisionTower(width=E, layers=2, heads=2, out_dim=64),
                               torch.Generator().manual_seed(20))
    text = init_clip_weights(CLIPTextTower(vocab_size=1000, width=E, layers=2, heads=2),
                             torch.Generator().manual_seed(21))
    with torch.no_grad():  # features of unit scale, so that the pixels move the tokens
        vision.class_embedding.zero_()
        vision.positional_embedding.zero_()
        vision.proj.mul_(30.0)
    return vision.to(dev).eval(), text.to(dev).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["vision", "text"])
def test_graphed_towers_equal_the_eager_towers(cuda, which):
    """The towers' runners (``graphs.StagedModule`` keyed on ``pixels``, as
    the server and the extract CLI build it, and on ``tokens``, the text
    encoder's) on the card: a shape's first call and two
    replays give the eager tower's features bit for bit, into results of
    their own; one graph per shape."""
    from vct_tpu_torch import graphs

    vision, text = _towers(cuda)
    g = torch.Generator().manual_seed(22)
    if which == "vision":
        fn, tower = graphs.StagedModule(vision, "pixels"), vision
        inputs = [torch.randn((f, 224, 224, 3), generator=g).to(cuda) for f in (5, 5, 3)]
    else:
        fn, tower = graphs.StagedModule(text, "tokens"), text
        inputs = []
        for rows in (8, 8, 3):
            toks = torch.randint(1, 998, (rows, 77), generator=g, dtype=torch.int32)
            toks[torch.arange(rows), torch.randint(5, 77, (rows,), generator=g)] = 999  # EOT
            inputs.append(toks.to(cuda))
    with torch.no_grad():
        wants = [tower(x) for x in inputs]
    gots = [fn(x) for x in (*inputs, inputs[0])]
    torch.cuda.synchronize()
    for got, want in zip(gots, (*wants, wants[0])):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert gots[0].data_ptr() != gots[3].data_ptr()
    assert (fn.sets, fn.graphs, fn.replays) == (2, 2, 2)


@pytest.mark.cuda
def test_graphed_tower_gives_back_the_pools_it_drops(cuda):
    """Eight frame counts through the graphed tower: it keeps the last
    ``max_sets`` (4) sets, each replay bit for bit the eager tower's, and
    holds less device memory after ``empty_cache`` than a runner that keeps
    all eight: the dropped sets' pools went back to the card."""
    from vct_tpu_torch import graphs

    vision, _ = _towers(cuda)
    px = torch.randn((40, 224, 224, 3), generator=torch.Generator().manual_seed(24)).to(cuda)
    counts = range(33, 41)  # each pool holds its patches, 20-25 MB
    grown = {}
    for bound in (4, None):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(cuda)
        fn = graphs.StagedModule(vision, "pixels")
        fn.max_sets = bound
        for f in (*counts, *counts[-2:]):
            got = fn(px[:f])
            with torch.no_grad():
                assert torch.equal(got, vision(px[:f])), f
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        grown[bound] = torch.cuda.memory_reserved(cuda) - before
        assert len(fn._sets) == len(counts[-(bound or 8):])
        assert (fn.sets, fn.graphs, fn.replays) == (8, 8, 2)
        del fn, got
    assert 0 < grown[4] < grown[None], grown


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "beam", "attn"])
def test_graphed_pixel_program_equals_the_eager_composition(cuda, mode):
    """``make_video_caption_fn`` on the card, bf16 captioner: one program from
    pixels to tokens whose first call and replays give the eager composition's
    bits (the tower, then ``greedy_generate_fused`` / ``beam_generate_fused``
    / the module path with attention maps); the kernels the eager decode
    launches, once a replay."""
    from vct_tpu_torch.decode import greedy_generate
    from vct_tpu_torch.decode_fast import beam_generate_fused, greedy_generate_fused
    from vct_tpu_torch.pipeline import make_video_caption_fn

    model = _graph_model(cuda, torch.bfloat16, seed=4)
    vision, _ = _towers(cuda)
    g = torch.Generator().manual_seed(23)
    batches = [torch.randn((2, 4, 224, 224, 3), generator=g).to(cuda) for _ in range(2)]
    kw = dict(max_len=30, start_id=101, end_id=-1)

    def eager(px):
        with torch.no_grad():
            feats = [vision(px.reshape(-1, 224, 224, 3)).reshape(2, 4, -1).float()]
        masks = [torch.zeros((2, 4), dtype=torch.bool, device=cuda)]
        if mode == "beam":
            return beam_generate_fused(model, feats, masks, beam_size=4, **kw)
        if mode == "attn":
            return greedy_generate(model, feats, masks, collect_attn=True, **kw)
        return greedy_generate_fused(model, feats, masks, **kw)

    fn = make_video_caption_fn.__wrapped__(model, vision, beam_size=4 if mode == "beam" else 0,
                                           collect_attn=mode == "attn", **kw)
    counted = {"greedy": {"fused_whole_step": 29}, "attn": {},  # 29 tokens: runs free
               "beam": {"fused_layers_step": 29, "fused_norm_generator_topk": 29}}[mode]
    for px in (*batches, batches[0]):
        before = {k.__name__: k.launches for k in dk.WRAPPERS}
        want = eager(px)
        mid = {k.__name__: k.launches for k in dk.WRAPPERS}
        got = fn(px)
        torch.cuda.synchronize()
        for gv, wv in zip(got, want):
            assert (gv is None) == (wv is None)
            assert gv is None or torch.equal(gv, wv)
        for counts, since in ((mid, before), ({k.__name__: k.launches for k in dk.WRAPPERS},
                                              mid)):
            assert {k: v - since[k] for k, v in counts.items() if v != since[k]} == counted
    assert not torch.equal(eager(batches[0])[0], eager(batches[1])[0])
    assert (fn.runner.sets, fn.runner.graphs, fn.runner.replays) == (1, 4, 8)
