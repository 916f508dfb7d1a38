"""What the redesigned attention backward and top-k kernels rest on that a CPU
can check: their launch plans (``attention_backward_plan``, ``gen_topk_plan``,
which mirror ``vct_attn_backward_plan`` in ``csrc/attention.cu`` and
``vct_gen_topk_plan`` in ``csrc/gen_topk.cu``) against their rules and
boundaries, and plain float32 models of how the kernels split the work,
against the plain versions the port holds to ``vct_tpu``:

* the backward as kernel 1 computes it (per 64-row query tile: P and dP over
  the key tiles, delta = rowsum(P dP) in one sweep, then dS and dQ = dS K)
  and kernel 2 (per 64-key tile: P, dP and dS recomputed over the query tiles
  in ascending order, dV += Pd^T dO, dK += dS^T Q), from the forward's saved
  row max and sum;
* the top-k as the tensor-core route computes it (per 256-column slab the
  k best keys, the max and the sum of exp, then the fixed-order merge).

The card tests (``test_torch_port_cuda.py``) hold the plans against the C
launchers and the kernels against these plain versions.
"""

import math

import numpy as np
import pytest
import torch

from vct_tpu_torch.ops import attention_kernels as ak
from vct_tpu_torch.ops import decode_kernels as dk

SMEM_LIMIT = 232448  # what one block may have on an H100
TILE = 64            # query rows of kernel 1's block and keys of kernel 2's
SLAB = 256           # vocab columns of a top-k slab


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 64, 96, 128])
@pytest.mark.parametrize("has_keep", [False, True])
def test_backward_plan_rule_and_boundaries(d, has_keep):
    """bfloat16: 64-row query tiles while kernel 1's P and dP over Tk, the
    ring and the keep tiles fit a block, the replaced pair past that; float32
    always the replaced pair."""
    last_route = 1
    for tk in range(1, 1500, 7):
        plan = ak.attention_backward_plan(tk, d, torch.bfloat16, has_keep)
        ring = 2 * (2 * 64 * (d + 8) * 2)
        tiles = -(-tk // 64) * 64
        if 64 * tiles * 8 + ring + (2 * 64 * 80 if has_keep else 0) <= SMEM_LIMIT:
            assert (plan.route, plan.tile_q, plan.tile_k) == (1, TILE, TILE)
            assert plan.smem_dq <= SMEM_LIMIT and plan.smem_dkv <= SMEM_LIMIT
            assert plan.threads == 256 and plan.stages == 2
        else:
            assert plan.route == 0
            assert plan == ak.attention_backward_plan(tk, d, torch.bfloat16, has_keep, 0)
        # the route only ever steps down as Tk grows: the on-chip route, then the old pair
        assert plan.route <= last_route
        last_route = plan.route
        assert ak.attention_backward_plan(tk, d, torch.float32, has_keep).route == 0


def test_backward_plan_at_the_long_recipe_and_its_limits():
    bf16 = torch.bfloat16
    for tk in (128, 256, 320):  # the long recipe's shapes take 64-row tiles
        assert ak.attention_backward_plan(tk, 96, bf16, True)[:2] == (1, 64)
    assert ak.attention_backward_plan(320, 96, bf16, False)[:2] == (1, 64)
    assert ak.attention_backward_plan(321, 96, bf16, True).route == 0
    assert ak.attention_backward_plan(321, 96, bf16, False).route == 0
    # the replaced pair's shared memory, as before the redesign
    old = ak.attention_backward_plan(256, 96, bf16, True, route=0)
    assert (old.smem_dq, old.smem_dkv) == (122880, 157696)
    with pytest.raises(ValueError):
        ak.attention_backward_plan(321, 96, bf16, True, route=1)
    with pytest.raises(ValueError):
        ak.attention_backward_plan(128, 96, torch.float32, True, route=1)
    with pytest.raises(ValueError):
        ak.attention_backward_plan(128, 100, bf16, True)
    with pytest.raises(TypeError):
        ak.attention_backward_plan(128, 96, torch.float16, True)


@pytest.mark.parametrize("b", [1, 64, 65, 128, 200, 256])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_topk_plan_rule(b, k):
    """bfloat16 takes the argmax route's tiles and ring with the top-k
    epilogue's bytes on top; float32 the CUDA-core partial kernel; both use
    256-column slabs, so the merge's column blocks do not change."""
    e, v = 768, 30720
    plan = dk.gen_topk_plan(b, e, v, k, torch.bfloat16)
    arg = dk.gen_argmax_plan(b, e, v, torch.bfloat16)
    rows = 64 if b <= 64 else 128
    assert plan.route == 1 and plan[1:5] == arg[1:5] and plan[6:] == arg[6:]
    assert plan.smem_bytes == arg.smem_bytes - 8 * rows * 8 + 8 * rows * 12 + rows * 8
    assert plan.smem_bytes <= SMEM_LIMIT and plan.n_tiles == -(-v // SLAB)
    old = dk.gen_topk_plan(b, e, v, k, torch.bfloat16, route=0)
    assert old == dk.gen_topk_plan(b, e, v, k, torch.float32)
    assert (old.route, old.rows, old.cols, old.m_tiles, old.n_tiles) == (
        0, 8, SLAB, -(-b // 8), -(-v // SLAB))


def test_topk_plan_refuses_what_no_route_takes():
    bf16 = torch.bfloat16
    for bad in (dict(k=0), dict(k=33), dict(v=1004), dict(e=100), dict(b=0)):
        a = dict(b=4, e=768, v=1024, k=4) | bad
        with pytest.raises(ValueError):
            dk.gen_topk_plan(a["b"], a["e"], a["v"], a["k"], bf16)
    with pytest.raises(ValueError):
        dk.gen_topk_plan(4, 768, 1024, 4, torch.float32, route=1)
    with pytest.raises(ValueError):
        dk.gen_topk_plan(4, 768, 8, 16, bf16)  # k above the vocab
    with pytest.raises(TypeError):
        dk.gen_topk_plan(4, 768, 1024, 4, torch.float16)


# ---------------------------------------------------------------------------
# the backward's split
# ---------------------------------------------------------------------------


def _attn_case(b, tq, tk, h, d, bias_kind, rate, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                  for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d), (b, tq, h, d)))
    bias = None
    if bias_kind == "padding":
        bias = torch.zeros((b, 1, 1, tk))
        bias[1::2, ..., tk - tk // 3:] = ak.NEG_INF
    elif bias_kind == "full":
        bias = torch.tensor(rng.standard_normal((b, h, tq, tk)), dtype=torch.float32)
        bias[0, 0, tq // 2] = ak.NEG_INF  # a fully masked row
    keep = None
    if rate > 0:
        keep = torch.tensor(rng.random((b, h, tq, tk)) >= rate)
    return q, k, v, bias, keep, g


def _split_backward(q, k, v, bias, keep, rate, g):
    """float32, tile by tile, as the two kernels order the work."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, gh = (t.permute(0, 2, 1, 3) for t in (q, k, v, g))  # [B, H, T, D]
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if bias is not None:
        logits = logits + bias
    m = logits.max(dim=-1).values  # the forward's saved statistics
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    inv_keep = 1.0 / (1.0 - rate)

    def tile_terms(q0, k0):
        rows, cols = slice(q0, q0 + TILE), slice(k0, k0 + TILE)
        s = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, rows], kh[:, :, cols]) * scale
        if bias is not None:
            s = s + bias.expand(b, h, tq, tk)[:, :, rows, cols]
        p = torch.exp(s - m[:, :, rows, None]) * (1.0 / l[:, :, rows, None])
        dp = torch.einsum("bhqd,bhkd->bhqk", gh[:, :, rows], vh[:, :, cols])
        pd = p
        if keep is not None:
            kept = keep[:, :, rows, cols]
            pd = torch.where(kept, p * inv_keep, 0.0)
            dp = torch.where(kept, dp * inv_keep, 0.0)
        return p, pd, dp

    dq = torch.zeros_like(qh)
    delta = torch.zeros((b, h, tq))
    for q0 in range(0, tq, TILE):  # kernel 1: one query tile, two sweeps
        parked = [tile_terms(q0, k0) for k0 in range(0, tk, TILE)]
        d_rows = sum((p * dp).sum(dim=-1) for p, _, dp in parked)
        delta[:, :, q0:q0 + TILE] = d_rows
        for i, (p, _, dp) in enumerate(parked):
            ds = p * (dp - d_rows[..., None]) * scale
            dq[:, :, q0:q0 + TILE] += ds @ kh[:, :, i * TILE:(i + 1) * TILE]
    dk_, dv_ = torch.zeros_like(kh), torch.zeros_like(vh)
    for k0 in range(0, tk, TILE):  # kernel 2: one key tile over ascending query tiles
        for q0 in range(0, tq, TILE):
            p, pd, dp = tile_terms(q0, k0)
            ds = p * (dp - delta[:, :, q0:q0 + TILE, None]) * scale
            dv_[:, :, k0:k0 + TILE] += pd.transpose(-1, -2) @ gh[:, :, q0:q0 + TILE]
            dk_[:, :, k0:k0 + TILE] += ds.transpose(-1, -2) @ qh[:, :, q0:q0 + TILE]
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk_, dv_))


@pytest.mark.parametrize("shape", [(2, 31, 13, 2, 32), (1, 70, 130, 2, 16), (2, 65, 65, 1, 48),
                                   (1, 129, 200, 1, 16)])
@pytest.mark.parametrize("bias_kind", [None, "padding", "full"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_split_backward_equals_the_plain_version(shape, bias_kind, rate):
    """The tile split at ragged Tq and Tk gives the plain version's dQ, dK
    and dV to float32 summation order: 1e-5 of the largest gradient."""
    args = _attn_case(*shape, bias_kind, rate, seed=sum(shape))
    got = _split_backward(*args[:5], rate, args[5])
    want = ak.fused_attention_backward_reference(*args[:5], rate, args[5])
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())


# ---------------------------------------------------------------------------
# the top-k's split
# ---------------------------------------------------------------------------


def _keys(vals, cols):
    """The kernels' 64-bit order as a Python tuple: larger value first, then
    the lower column."""
    return [(float(x), -int(c)) for x, c in zip(vals, cols)]


def _slab_topk(logits, k):
    """Per row: every slab's k best keys (fewer in a short last slab), max
    and sum of exp; then the merge: k passes over the candidates, each the
    largest below the last taken, and the slabs' (max, sum) folded in
    ascending order."""
    b, v = logits.shape
    topv = torch.empty((b, k))
    topi = torch.empty((b, k), dtype=torch.int64)
    lse = torch.empty((b,))
    for r in range(b):
        cands, parts = [], []
        for s0 in range(0, v, SLAB):
            cols = torch.arange(s0, min(s0 + SLAB, v))
            keys = sorted(_keys(logits[r, cols], cols), reverse=True)[:k]
            cands += keys
            vals = logits[r, cols]
            m = float(vals.max())
            parts.append((m, float(torch.exp(vals - m).sum())))
        taken = sorted(cands, reverse=True)[:k]
        topv[r] = torch.tensor([x for x, _ in taken])
        topi[r] = torch.tensor([-c for _, c in taken])
        m = max(p[0] for p in parts)
        lse[r] = m + math.log(sum(s * math.exp(pm - m) for pm, s in parts))
    return topv, topi, lse


@pytest.mark.parametrize("k", [1, 2, 4, 7, 16, 32])
@pytest.mark.parametrize("v", [1000, 300])
def test_slab_topk_and_merge_equal_first_win_topk(k, v):
    """V not a multiple of 256 (a short last slab), logits rounded so that
    ties fall inside and across slabs: the same ids as ``topk_first_win``,
    the same values, and its logsumexp to 1e-5."""
    rng = np.random.default_rng(k * v)
    logits = torch.tensor(np.round(rng.standard_normal((6, v)) * 4) / 4, dtype=torch.float32)
    logits[0, [3, 260, 700 % v, v - 1]] = 50.0  # one value in three or four slabs
    topv, topi, lse = _slab_topk(logits, k)
    want_v, want_i = dk.topk_first_win(logits, k)
    assert torch.equal(topi, want_i) and torch.equal(topv, want_v)
    assert torch.allclose(lse, torch.logsumexp(logits, dim=-1), atol=1e-5, rtol=1e-6)
    if k >= 4:
        assert topi[0, :4].tolist() == sorted({3, 260, 700 % v, v - 1})[:4]
