"""What the small-row token path of ``csrc/small_step.cu`` (bfloat16
``fused_whole_step``, ``fused_multi_step`` windows and ``fused_layers_step``
at 1-64 rows) rests on that a CPU can check:

* the launch plans ``whole_step_plan``, ``multi_step_plan`` and the small-row
  route of ``stack_step_plan``, which mirror the C launchers (the card tests
  hold them to what the launchers report): the rule, its boundaries at B = 1,
  64 and 65, float32, widths that are not multiples of 64, head widths above
  128, and the refusals;
* a float32 model of how the kernel splits the work: each block's 8-column
  units over the whole K, the K steps of 16 dealt to the eight warps in turn,
  each warp's sums added with compensation and the warps' partials added in
  warp order, LayerNorm once per row; run through the whole step and the
  multi-token window against ``fused_whole_step_reference`` and
  ``fused_multi_step_reference`` at B = 1, 7 and 64.

The plain versions' parity with ``vct_tpu``'s Pallas kernels in interpret mode
is held by ``test_torch_port_kernels.py`` and ``test_torch_port_multistep.py``.
Tolerances: the model sums in another order than the plain versions, so
activations agree to 1e-5 of their largest value, and tokens wherever the
plain logits' top-2 gap is above 1e-4.
"""

import numpy as np
import pytest
import torch

from vct_tpu_torch.ops import decode_kernels as dk

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132   # the H100's SMs: one block each in the cooperative launch
GAP = 1e-4

# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

MSVD = (768, 8, 2048, 30720)   # E, heads, F, padded vocab


@pytest.mark.parametrize("plan_fn", [dk.whole_step_plan, dk.multi_step_plan])
@pytest.mark.parametrize("b,e,heads,f,v,dtype,route,want", [
    # the rule: bfloat16 at 1-64 rows within every limit takes the small-row kernel
    (1, *MSVD, BF16, -1, (1, 0)), (64, *MSVD, BF16, -1, (1, 0)),
    (7, 128, 4, 256, 640, BF16, -1, (1, 0)),
    (32, 1024, 8, 2304, 1024, BF16, -1, (1, 0)), (32, 768, 96, 2048, 1024, BF16, -1, (1, 0)),
    # and says why it does not
    (65, *MSVD, BF16, -1, (0, 3)), (1, *MSVD, F32, -1, (0, 2)), (64, *MSVD, F32, -1, (0, 2)),
    (32, *MSVD, BF16, 0, (0, 1)),
    (32, 96, 12, 256, 1024, BF16, -1, (0, 4)), (32, 768, 8, 2000, 1024, BF16, -1, (0, 4)),
    (32, 1280, 8, 2048, 1024, BF16, -1, (0, 5)), (32, 768, 2, 2048, 1024, BF16, -1, (0, 6)),
    (32, 768, 8, 2560, 1024, BF16, -1, (0, 7)),
    # asked for
    (64, *MSVD, BF16, 1, (1, 0)), (1, 128, 4, 256, 640, F32, 0, (0, 1)),
])
def test_small_plans_rule_and_boundaries(plan_fn, b, e, heads, f, v, dtype, route, want):
    plan = plan_fn(b, e, heads, f, v, dtype, route)
    assert (plan.route, plan.why) == want
    assert plan.why in dk.SMALL_WHY
    if plan.route == 1:
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (16, 8, 256, 4)
        assert plan.smem_bytes == 212992 <= 232448
    else:
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (8, 32, 0, 0)
        step = 4 * (8 * max(e, f) + 8 * 8 * 32 + 8 * 1024)   # decode_step_kernel's
        extra = 4 * ((2 * b + 3) // 4 * 4) if plan_fn is dk.multi_step_plan else 0
        assert plan.smem_bytes == step + extra


@pytest.mark.parametrize("plan_fn", [dk.whole_step_plan, dk.multi_step_plan])
@pytest.mark.parametrize("b,e,heads,f,v,dtype,route", [
    (65, *MSVD, BF16, 1), (1, *MSVD, F32, 1), (32, 768, 8, 2560, 1024, BF16, 1),
    (0, *MSVD, BF16, -1), (32, 768, 7, 2048, 1024, BF16, -1), (32, 768, 8, 2048, 1020, BF16, -1),
    (32, *MSVD, BF16, 2), (32, *MSVD, torch.float16, -1),
])
def test_small_plans_refuse(plan_fn, b, e, heads, f, v, dtype, route):
    with pytest.raises((ValueError, TypeError)):
        plan_fn(b, e, heads, f, v, dtype, route)


@pytest.mark.parametrize("b,f,dtype,route,want", [
    (1, 2048, BF16, -1, (2, 0)), (64, 2048, BF16, -1, (2, 0)), (65, 2048, BF16, -1, (1, 0)),
    (64, 2048, F32, -1, (0, 2)), (64, 2560, BF16, -1, (0, 7)), (65, 2560, BF16, -1, (1, 0)),
    (1, 2048, BF16, 1, (1, 0)), (64, 2048, BF16, 2, (2, 0)), (64, 2048, BF16, 0, (0, 1)),
])
def test_stack_plan_small_row_route(b, f, dtype, route, want):
    plan = dk.stack_step_plan(b, 768, 8, f, dtype, route)
    assert (plan.route, plan.why) == want


@pytest.mark.parametrize("b", [1, 7, 32, 63, 64, 65, 128])
def test_greedy_and_beam_stacks_share_the_row_rule(b):
    """Where the whole step takes the small-row kernel, so does the stack a
    beam runs (route 2): greedy and a beam of 1 sum alike."""
    whole = dk.whole_step_plan(b, *MSVD, BF16).route == 1
    stack = dk.stack_step_plan(b, 768, 8, 2048, BF16).route == 2
    assert whole == stack == (b <= dk.SMALL_MAX_ROWS)


@pytest.mark.parametrize("b,e,f", [(1, 768, 2048), (64, 768, 2048), (7, 128, 256),
                                   (64, 1024, 2304)])
def test_scratch_holds_the_small_row_kernels_buffers(b, e, f):
    """float32 q, r, xf and bfloat16 att, xb, xin [B, E], hid [B, F], then the
    generator's hi/lo parts [2, 64, E] (csrc/small_step.cu ``scratch_of``)."""
    scratch = dk._scratch(b, e, f, "cpu")
    assert scratch.numel() * 4 >= b * (3 * 4 * e + 3 * 2 * e + 2 * f) + 2 * 64 * e * 2
    assert scratch.numel() >= b * (5 * e + f)   # decode_step_kernel's


# ---------------------------------------------------------------------------
# a float32 model of the small-row work split
# ---------------------------------------------------------------------------


def _units(n_cols, block):
    """The 8-column units block ``block`` of the grid owns (``my_units``)."""
    n = n_cols // 8
    return range(block * n // SMS, (block + 1) * n // SMS)


def _product(a, w, bias):
    """A [B, K] . W [K, N] + bias as the kernel sums it: block b takes its
    units (8 columns each, over the whole K); each K step of 16 is one MMA
    summed from zero; step s goes to warp s % 8, which adds its steps' sums
    with compensation (Kahan); the eight warps' partials are added in warp
    order, then the bias."""
    b, k = a.shape
    steps = k // 16
    out = torch.full((b, w.shape[1]), float("nan"))
    owner = torch.zeros(w.shape[1] // 8, dtype=torch.int64)
    for block in range(SMS):
        for u in _units(w.shape[1], block):
            owner[u] += 1
            cols = slice(8 * u, 8 * u + 8)
            part = torch.einsum("bsk,skn->sbn", a.view(b, steps, 16),
                                w[:, cols].reshape(steps, 16, 8))
            total = torch.zeros((b, 8))
            for warp in range(8):
                acc, comp = torch.zeros((b, 8)), torch.zeros((b, 8))
                for s in range(warp, steps, 8):
                    y = part[s] - comp
                    t = acc + y
                    comp = (t - acc) - y
                    acc = t
                total = total + (acc - comp)
            out[:, cols] = total + bias[cols]
    assert bool((owner == 1).all())   # every unit has exactly one block
    return out


def _token_model(x, kc, vc, ck, cv, mem_bias, fw, idx, heads, l_view):
    """One token through the stack and the generator, as the kernel orders
    it, in float32 -> (tokens [B], x_out)."""
    w = fw["stacked"]
    nl, big_l = kc.shape[:2]
    e = x.shape[1]
    nself = min(idx + 1, l_view)
    xin = x
    for li in range(nl):
        qkv = _product(xin, w["wqkv"][li], w["bqkv"][li])
        if idx < big_l:
            kc[li, idx] = qkv[:, e:2 * e]
            vc[li, idx] = qkv[:, 2 * e:]
        att = dk._attend(qkv[:, :e], kc[li, :nself], vc[li, :nself], heads, None)
        x1 = dk._ln(xin + _product(att, w["wo"][li], w["bo"][li]), w["n1s"][li], w["n1b"][li])
        ca = dk._attend(_product(x1, w["wcq"][li], w["bcq"][li]), ck[li], cv[li], heads, mem_bias)
        x2 = dk._ln(x1 + _product(ca, w["wco"][li], w["bco"][li]), w["n2s"][li], w["n2b"][li])
        h = torch.nn.functional.gelu(_product(x2, w["w1"][li], w["b1"][li]))
        xin = dk._ln(x2 + _product(h, w["w2"][li], w["b2"][li]), w["n3s"][li], w["n3b"][li])
    logits = dk._ln(xin, fw["norm_s"], fw["norm_b"]) @ fw["wg"] + fw["bg"]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return (torch.full_like(tok, -1) if idx >= l_view else tok), xin


def _model_data(b, seed, e=128, heads=4, f=256, nl=2, v=600, v_pad=640, big_l=16, tm=7, idx=5):
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0):
        return torch.tensor((rng.standard_normal(s) * scale).astype(np.float32))

    w = {"wqkv": n(nl, e, 3 * e, scale=e ** -0.5), "bqkv": n(nl, 3 * e, scale=0.1),
         "wo": n(nl, e, e, scale=e ** -0.5), "bo": n(nl, e, scale=0.1),
         "wcq": n(nl, e, e, scale=e ** -0.5), "bcq": n(nl, e, scale=0.1),
         "wco": n(nl, e, e, scale=e ** -0.5), "bco": n(nl, e, scale=0.1),
         "w1": n(nl, e, f, scale=e ** -0.5), "b1": n(nl, f, scale=0.1),
         "w2": n(nl, f, e, scale=f ** -0.5), "b2": n(nl, e, scale=0.1)}
    for k in dk._NORM_KEYS:
        w[k] = (1.0 + n(nl, e, scale=0.1)) if k.endswith("s") else n(nl, e, scale=0.1)
    wg = torch.zeros((e, v_pad))
    wg[:, :v] = n(e, v, scale=0.2)
    bg = torch.full((v_pad,), dk.NEG_INF)
    bg[:v] = n(v, scale=0.1)
    fw = {"stacked": w, "norm_s": 1.0 + n(e, scale=0.1), "norm_b": n(e, scale=0.1), "wg": wg,
          "bg": bg, "emb": n(v, e, scale=0.5), "pe": n(big_l, e, scale=0.5), "heads": heads}
    kc, vc = n(nl, big_l, b, e), n(nl, big_l, b, e)
    kc[:, idx:] = 0.0
    vc[:, idx:] = 0.0
    mem_bias = torch.zeros((b, tm))
    mem_bias[1::2, -3:] = dk.NEG_INF
    return fw, (n(b, e), kc, vc, n(nl, tm, b, e), n(nl, tm, b, e), mem_bias)


def _plain_gaps(x_ref, fw):
    logits = dk._ln(x_ref, fw["norm_s"], fw["norm_b"]) @ fw["wg"] + fw["bg"]
    top = torch.topk(logits, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("idx,l_view", [(5, 8), (8, 8)])
def test_whole_step_work_split_model_matches_plain_version(b, idx, l_view):
    """The modelled kernel order against ``fused_whole_step_reference``: the
    fresh cache rows to 1e-5 of their largest value, the tokens equal (but
    at near-ties), -1 when idx >= l_view."""
    fw, (x, kc, vc, ck, cv, mb) = _model_data(b, seed=b + idx, idx=idx)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    tok, x_out = _token_model(x, k1, v1, ck, cv, mb, fw, idx, fw["heads"], l_view)
    want, _, _ = dk.fused_whole_step_reference(x, k2, v2, ck, cv, mb, fw, idx,
                                               heads=fw["heads"], l_view=l_view)
    for got, ref in ((k1[:, idx], k2[:, idx]), (v1[:, idx], v2[:, idx])):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    x_ref = dk._stack_reference(x, kc.clone(), vc.clone(), ck, cv, mb, fw["stacked"], idx,
                                fw["heads"], l_view)
    assert float((x_out - x_ref).abs().max()) <= 1e-5 * float(x_ref.abs().max())
    if idx >= l_view:
        assert bool((tok == -1).all()) and bool((want == -1).all())
    else:
        differ = tok != want
        assert bool((_plain_gaps(x_ref, fw)[differ] < GAP).all())


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("u,w_idx", [(2, 1), (4, 0)])
def test_multi_step_work_split_model_matches_plain_version(b, u, w_idx):
    """A window of ``u`` tokens: the modelled token in a loop, each token's
    argmax embedded as the next input (pad id 0 embeds to zero), against
    ``fused_multi_step_reference``: the same chain, the same cache rows."""
    fw, (_, kc, vc, ck, cv, mb) = _model_data(b, seed=100 + b + u, idx=w_idx * u)
    rng = np.random.default_rng(b)
    cur = torch.tensor(rng.integers(0, 600, b).astype(np.int32))
    cur[0] = 0
    l_view = 8
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    want, _, _ = dk.fused_multi_step_reference(cur, k2, v2, ck, cv, mb, fw["emb"], fw["pe"], fw,
                                               w_idx, heads=fw["heads"], unroll=u, pad_id=0,
                                               l_view=l_view)
    toks, c = [], cur
    for j in range(u):
        pos = w_idx * u + j
        x = dk._embed_step(fw["emb"], fw["pe"], c, pos, 0)
        c, _ = _token_model(x, k1, v1, ck, cv, mb, fw, pos, fw["heads"], l_view)
        toks.append(c)
    got = torch.stack(toks, dim=1)
    assert torch.equal(got, want)
    rows = slice(w_idx * u, w_idx * u + u)
    for a, r in ((k1[:, rows], k2[:, rows]), (v1[:, rows], v2[:, rows])):
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())
