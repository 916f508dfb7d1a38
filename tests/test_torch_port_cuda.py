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
    wide = torch.zeros((LN, lk.MAX_E + 128), dtype=torch.bfloat16, device=cuda)
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
    import ctypes

    from vct_tpu_torch.ops._build import load_library

    out = (ctypes.c_int * n)()
    assert getattr(load_library(), fn)(*args, out) == 0
    return tuple(out)


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
