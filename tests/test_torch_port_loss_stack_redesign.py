"""What the redesigned bfloat16 routes of ``sce_backward_tiles`` (the fused
loss's backward, ``csrc/sce_loss.cu``) and ``fused_layers_step`` (the decoder
stack, ``csrc/stack_step.cu``) rest on that a CPU can check:

* their launch plans, ``sce_backward_plan`` and ``stack_step_plan``, which
  mirror the C launchers (the card tests hold them to what the launchers
  report): the rule, its boundaries and its refusals;
* float32 models of how the new kernels split the work, against the plain
  versions: the backward's 128-row x 256-column dz tiles, its 32-row dbg
  groups summed as the kernel sums them, and dx over vocab groups merged in
  ascending order; the stack's products in 64-row x 64-column units and its
  LayerNorm once per row;
* the plain versions against ``vct_tpu``'s Pallas kernels (interpret mode) on
  the same seeded numpy inputs, at a row count that is ragged against both
  the 32-row dbg groups and the 128-row tiles, and at beam-like row counts.

Tolerances: the float32 models sum in another order than the plain versions,
so they agree to 1e-5 of the largest value. Against the Pallas kernels, as
``test_torch_port_fused_loss.py`` (dz within one bfloat16 unit in all but
0.1% of the elements, gradients to 1e-5 / 5e-3 of their largest value) and
``test_torch_port_kernels.py`` (1e-4 in float32, 8e-2 in bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.ops import fused_loss as jfl
from vct_tpu.ops import pallas_decode as jpd
from vct_tpu.ops import pallas_loss as jpl
from vct_tpu_torch.ops import decode_kernels as dk
from vct_tpu_torch.ops import loss_kernels as lk

BF16, F32 = torch.bfloat16, torch.float32
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}

# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,v,dtype,route,want", [
    # the rule: bfloat16 up to BWD_MAX_N rows takes the tensor-core pair
    (1984, 768, 30522, BF16, -1, 1), (1, 128, 1, BF16, -1, 1),
    (lk.BWD_MAX_N, 1664, 30522, BF16, -1, 1), (lk.BWD_MAX_N + 1, 768, 30522, BF16, -1, 0),
    (1984, 768, 30522, F32, -1, 0), (300, 896, 3000, F32, -1, 0),
    # asked for
    (1984, 768, 30522, BF16, 0, 0), (1984, 768, 30522, BF16, 1, 1), (300, 896, 3000, F32, 0, 0),
])
def test_backward_plan_rule_and_boundaries(n, e, v, dtype, route, want):
    plan = lk.sce_backward_plan(n, e, v, dtype, route)
    assert plan.route == want
    v_pad = -(-v // 512) * 512
    if want == 1:
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (128, 256, 64, 4)
        assert plan.slabs == v_pad // 256 and plan.row_tiles == -(-n // 128)
        assert plan.grid == min(plan.row_tiles * plan.slabs, lk.H100_SMS)
        assert plan.e_tiles == -(-e // 256)
        assert plan.dx_units == -(-n // 128) * plan.e_tiles * plan.groups
        assert max(plan.smem_bytes, plan.dx_smem_bytes) <= 232448
    else:
        assert (plan.rows, plan.groups, plan.dx_units) == (lk.ROW_TILE[dtype], 1, 0)
        assert plan.e_tiles == -(-e // 768)   # backward_kernel's dx column slabs


@pytest.mark.parametrize("n,e,v,dtype,route", [
    (1984, 768, 30522, F32, 1),                    # no tensor-core route in float32
    (lk.BWD_MAX_N + 1, 768, 30522, BF16, 1),       # past its rows
    (0, 768, 30522, BF16, -1), (100, 100, 30522, BF16, -1), (100, 768, 0, BF16, -1),
    (100, 768, 30522, BF16, 2), (100, 768, 30522, torch.float16, -1),
])
def test_backward_plan_refuses(n, e, v, dtype, route):
    with pytest.raises((ValueError, TypeError)):
        lk.sce_backward_plan(n, e, v, dtype, route)


@pytest.mark.parametrize("n,e,v,groups,units", [
    (1984, 768, 30522, 5, 240),    # 48 tiles: the MSVD train step
    (4096, 768, 30522, 4, 384),    # 96 tiles: the long-video step
    (1000, 768, 30522, 5, 120),
    (256, 768, 30522, 16, 96),     # 6 tiles: no count fills 90%; 16 fills most
    (256, 768, 1111, 3, 18),       # 24 K steps cap the groups at 3
    (7936, 768, 30522, 2, 372),
])
def test_backward_plan_vocab_groups(n, e, v, groups, units):
    plan = lk.sce_backward_plan(n, e, v, BF16)
    assert (plan.groups, plan.dx_units) == (groups, units)


@pytest.mark.parametrize("tiles,ksteps,sms,want", [
    (48, 480, 132, 5), (96, 480, 132, 4), (132, 480, 132, 1), (66, 480, 132, 2),
    (6, 480, 132, 16), (6, 8, 132, 1), (6, 7, 132, 1), (1, 480, 1, 1),
])
def test_dx_groups_fill_rule(tiles, ksteps, sms, want):
    assert lk.dx_groups(tiles, ksteps, sms) == want


@pytest.mark.parametrize("b,e,heads,f,dtype,route,want", [
    # the rule: bfloat16 within every limit takes the tensor-core kernel
    (128, 768, 8, 2048, BF16, -1, (1, 0)), (256, 768, 8, 2048, BF16, -1, (1, 0)),
    (65, 768, 8, 2048, BF16, -1, (1, 0)), (65, 128, 4, 256, BF16, -1, (1, 0)),
    (dk.STACK_MAX_ROWS, 896, 8, 2048, BF16, -1, (1, 0)), (65, 768, 6, 2048, BF16, -1, (1, 0)),
    # and says why it does not
    (128, 768, 8, 2048, BF16, 0, (0, 1)), (128, 768, 8, 2048, F32, -1, (0, 2)),
    (dk.STACK_MAX_ROWS + 1, 768, 8, 2048, BF16, -1, (0, 3)),
    # at 64 rows and fewer the small-row kernel, whose sums are the whole step's
    (64, 768, 8, 2048, BF16, -1, (2, 0)), (1, 128, 4, 256, BF16, -1, (2, 0)),
    (128, 96, 12, 256, BF16, -1, (0, 4)), (128, 768, 8, 2000, BF16, -1, (0, 4)),
    (128, 1280, 8, 2048, BF16, -1, (0, 5)), (128, 768, 3, 2048, BF16, -1, (0, 6)),
    (128, 768, 96, 2048, BF16, -1, (1, 0)),   # a head width of 8, the narrowest
])
def test_stack_plan_rule_and_boundaries(b, e, heads, f, dtype, route, want):
    plan = dk.stack_step_plan(b, e, heads, f, dtype, route)
    assert (plan.route, plan.why) == want
    assert plan.why in dk.STACK_WHY
    if plan.route == 1:
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (64, 64, 64, 4)
        assert plan.smem_bytes == 139264   # the attention phase's staging, above the ring's
    elif plan.route == 2:
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (16, 8, 256, 4)
        assert plan.smem_bytes == 212992   # two weight slots and the attention staging
    else:
        assert (plan.rows, plan.cols) == (8, 32)   # decode_step_kernel's units


@pytest.mark.parametrize("b,e,heads,f,dtype,route", [
    (128, 768, 8, 2048, F32, 1), (dk.STACK_MAX_ROWS + 1, 768, 8, 2048, BF16, 1),
    (65, 768, 8, 2048, BF16, 2),   # the small-row kernel only at its rows
    (128, 768, 7, 2048, BF16, -1), (0, 768, 8, 2048, BF16, -1), (128, 768, 8, 2048, BF16, 3),
    (128, 768, 8, 2048, torch.float16, -1),
])
def test_stack_plan_refuses(b, e, heads, f, dtype, route):
    with pytest.raises((ValueError, TypeError)):
        dk.stack_step_plan(b, e, heads, f, dtype, route)


# ---------------------------------------------------------------------------
# float32 models of the new work splits against the plain versions
# ---------------------------------------------------------------------------


def _loss_data(n, e, v, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((n, e)).astype(np.float32))
    w = torch.tensor((rng.standard_normal((v, e)) * 0.05).astype(np.float32))
    b = torch.tensor((rng.standard_normal((v,)) * 0.01).astype(np.float32))
    labels = torch.tensor(rng.integers(0, v, (n,)).astype(np.int32))
    labels[:3] = v - 1
    labels[3:6] = torch.tensor([-1, v, v + 9], dtype=torch.int32)   # hit nothing
    u, cc, lt = (torch.tensor(rng.random(n).astype(np.float32) * 1e-2) for _ in range(3))
    for t in (u, cc, lt):
        t[8:12] = 0.0
    m, s, _ = lk.softmax_stats_reference(x, w, b, labels)
    return x, w, b, m + torch.log(s), u, cc, lt, labels


def _butterfly8(vals):
    """The kernel's sum over the 8 lanes of a column: partners 4, then 2, then
    1 apart (``vals`` [8, ...], lane g at index g)."""
    s4 = [vals[g] + vals[g + 4] for g in range(4)]
    s2 = [s4[g] + s4[g + 2] for g in range(2)]
    return s2[0] + s2[1]


def _backward_model(x, w, b, lse, u, cc, lt, labels):
    """sce_backward_tiles as the tensor-core route splits it, in float32."""
    n, e = x.shape
    v = w.shape[0]
    plan = lk.sce_backward_plan(n, e, v, BF16)
    v_pad = plan.slabs * plan.cols
    wp = torch.zeros((v_pad, e))
    wp[:v] = w
    bp = torch.full((v_pad,), lk.NEG_INF)
    bp[:v] = b
    lab = torch.where((labels >= 0) & (labels < v), labels, -1).long()
    rows_pad = plan.row_tiles * plan.rows
    dz = torch.zeros((rows_pad, v_pad))
    live = torch.arange(rows_pad) < n
    pad = rows_pad - n
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    lse_p = torch.nn.functional.pad(lse, (0, pad), value=float("inf"))   # dead rows: p = 0
    u_p, cc_p, lt_p = (torch.nn.functional.pad(t, (0, pad)) for t in (u, cc, lt))
    lab_p = torch.nn.functional.pad(lab, (0, pad), value=-1)
    dbg = torch.zeros((-(-n // 32), v_pad))
    for slab in range(plan.slabs):   # slab-major, as the persistent blocks walk
        c0 = slab * plan.cols
        for rt in range(plan.row_tiles):
            r = slice(rt * plan.rows, (rt + 1) * plan.rows)
            z = xp[r] @ wp[c0:c0 + plan.cols].t() + bp[c0:c0 + plan.cols]
            p = torch.exp(z - lse_p[r, None])
            d = p * (u_p[r, None] + cc_p[r, None] * (p > lk.EPS).float())
            hit = torch.arange(c0, c0 + plan.cols)[None, :] == lab_p[r, None]
            d = d - torch.where(hit, lt_p[r, None], 0.0)
            dz[r, c0:c0 + plan.cols] = d
            # a warp's 16 rows: rows g and g + 8 of each lane, then the 8 lanes;
            # the odd warp's sum added to the even warp's
            warp = d.view(8, 2, 8, plan.cols)   # [warp, h, g, column]
            per_warp = _butterfly8((warp[:, 0] + warp[:, 1]).transpose(0, 1))
            group = per_warp[0::2] + per_warp[1::2]
            for gi in range(4):
                if rt * 4 + gi < dbg.shape[0]:
                    dbg[rt * 4 + gi, c0:c0 + plan.cols] = group[gi]
    dz = dz[:n] * live[:n, None]
    kt = v_pad // 64
    parts = []
    for grp in range(plan.groups):
        k = slice(grp * kt // plan.groups * 64, (grp + 1) * kt // plan.groups * 64)
        parts.append(dz[:, k] @ wp[k])
    dx = parts[0]
    for part in parts[1:]:
        dx = dx + part
    return dx, dz[:, :-(-v // 512) * 512], dbg[:, :-(-v // 512) * 512]


@pytest.mark.parametrize("n,e,v", [(300, 128, 1111), (65, 256, 3000), (129, 128, 600)])
def test_backward_work_split_model_matches_plain_version(n, e, v):
    """Tiles, masks, the dbg grouping and the vocab groups of dx, in float32:
    the same dz, dbg partials and dx as the plain version to 1e-5 of their
    largest value."""
    args = _loss_data(n, e, v, seed=n + v)
    got = _backward_model(*args)
    dx, dz, parts = lk.sce_backward_tiles_reference(*args)
    # float32's plain version sums dbg over 16-row groups; bfloat16's over 32
    parts = torch.nn.functional.pad(parts, (0, 0, 0, parts.shape[0] % 2))
    want = dx, dz, parts[0::2] + parts[1::2]
    for name, a, r in zip(("dx", "dz", "dbg_parts"), got, want):
        assert a.shape == r.shape, name
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
    assert not got[1][8:12].any()   # rows of zero weight give exactly 0


def _units(a, w, bias, rows=64, cols=64):
    """A product as the stack kernel splits it: units of 64 rows x 64 columns,
    each over the whole K."""
    out = torch.empty((a.shape[0], w.shape[1]))
    for r0 in range(0, a.shape[0], rows):
        for c0 in range(0, w.shape[1], cols):
            out[r0:r0 + rows, c0:c0 + cols] = (a[r0:r0 + rows] @ w[:, c0:c0 + cols]
                                               + bias[c0:c0 + cols])
    return out


def _stack_model(x, kc, vc, ck, cv, mem_bias, w, idx, heads, l_view):
    """fused_layers_step as the tensor-core kernel orders it, in float32: the
    products in units, each LayerNorm once per row in its own pass."""
    nl, big_l = kc.shape[:2]
    e = x.shape[1]
    nself = min(idx + 1, l_view)
    ln_rows = {}

    def ln(r, s, b):   # a row pass: statistics once per row
        ln_rows["count"] = ln_rows.get("count", 0) + r.shape[0]
        return dk._ln(r, s, b)

    xin = x
    for li in range(nl):
        qkv = _units(xin, w["wqkv"][li], w["bqkv"][li])
        if idx < big_l:
            kc[li, idx] = qkv[:, e:2 * e]
            vc[li, idx] = qkv[:, 2 * e:]
        att = dk._attend(qkv[:, :e], kc[li, :nself], vc[li, :nself], heads, None)
        r1 = xin + _units(att, w["wo"][li], w["bo"][li])
        x1 = ln(r1, w["n1s"][li], w["n1b"][li])
        ca = dk._attend(_units(x1, w["wcq"][li], w["bcq"][li]), ck[li], cv[li], heads, mem_bias)
        x2 = ln(x1 + _units(ca, w["wco"][li], w["bco"][li]), w["n2s"][li], w["n2b"][li])
        h = torch.nn.functional.gelu(_units(x2, w["w1"][li], w["b1"][li]))
        xin = ln(x2 + _units(h, w["w2"][li], w["b2"][li]), w["n3s"][li], w["n3b"][li])
    assert ln_rows["count"] == 3 * nl * x.shape[0]
    return xin


def _stack_data(b, e, heads, f, nl, idx, seed, big_l=16, tm=7):
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
    kc, vc = n(nl, big_l, b, e), n(nl, big_l, b, e)
    kc[:, idx:] = 0.0
    vc[:, idx:] = 0.0
    mem_bias = torch.zeros((b, tm))
    mem_bias[1::2, -3:] = dk.NEG_INF
    return w, (n(b, e), kc, vc, n(nl, tm, b, e), n(nl, tm, b, e), mem_bias)


@pytest.mark.parametrize("b", [1, 65, 130])
@pytest.mark.parametrize("idx,l_view", [(5, 8), (12, 16)])
def test_stack_work_split_model_matches_plain_version(b, idx, l_view):
    """Units of 64 x 64 over ragged row tiles (65, 130 rows) and LayerNorm once
    per row: x_out and the fresh cache rows as the plain version's, float32,
    to 1e-5 of their largest value."""
    w, (x, kc, vc, ck, cv, mb) = _stack_data(b, 128, 4, 256, 2, idx, seed=b + idx)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = _stack_model(x, k1, v1, ck, cv, mb, w, idx, 4, l_view)
    want, _, _ = dk.fused_layers_step_reference(x, k2, v2, ck, cv, mb, w, idx, heads=4,
                                                l_view=l_view)
    for a, r in ((got, want), (k1[:, idx], k2[:, idx]), (v1[:, idx], v2[:, idx])):
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())


# ---------------------------------------------------------------------------
# the plain versions against vct_tpu's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [F32, BF16])
def test_backward_plain_version_matches_pallas_at_ragged_rows(dt):
    """N = 65: one row past two 32-row dbg groups, in the first 128-row tile;
    E = 256, V = 1111 (a partial last vocab tile); the generator bare, as the
    fused loss passes it."""
    n, e, v = 65, 256, 1111
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n, e)).astype(np.float32)
    wg = (rng.standard_normal((e, v)) * 0.05).astype(np.float32)   # the reference's [E, V]
    bg = (rng.standard_normal((v,)) * 0.01).astype(np.float32)
    labels = rng.integers(0, v, (n,)).astype(np.int32)
    labels[:3] = v - 1
    u, cc, lt = (rng.random(n).astype(np.float32) * 1e-2 for _ in range(3))
    xt = torch.tensor(x).to(dt)
    w, b = torch.tensor(wg.T.copy()).to(dt), torch.tensor(bg).to(dt)
    lab = torch.tensor(labels)
    m, s, _ = lk.softmax_stats_reference(xt, w, b, lab)
    lse = (m + torch.log(s)).numpy()
    x_p, w_dt, b_dt, lab_p, block_n, n_pad = jfl._pallas_pad_args(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(bg), jnp.asarray(labels), JDT[dt], bwd=True)

    def col(a):
        return jnp.pad(jnp.asarray(a, jnp.float32), (0, n_pad - n))[:, None]

    dx_j, dz_j, parts_j = jpl.sce_backward_tiles(x_p, w_dt, b_dt, col(lse), col(u), col(cc),
                                                 col(lt), lab_p, block_n=block_n, block_v=512,
                                                 interpret=True)
    dx, dz, parts = lk.sce_backward_tiles_reference(
        xt, w, b, torch.tensor(lse), torch.tensor(u), torch.tensor(cc), torch.tensor(lt), lab)
    dz_ref = np.asarray(dz_j.astype(jnp.float32))[:n]
    err = np.abs(dz.float().numpy() - dz_ref)
    if dt == F32:
        assert (err <= 1e-5 * np.abs(dz_ref) + 1e-9).all()
        gtol = 1e-5
    else:
        assert (err > 2.0 ** -7 * np.abs(dz_ref) + 1e-12).mean() < 1e-3
        assert (err <= 0.05 * np.abs(dz_ref) + 1e-12).all()
        gtol = 5e-3
    for got, want in ((dx.numpy(), np.asarray(dx_j)[:n]),
                      (parts.sum(0).numpy(), np.asarray(parts_j)[::8].sum(0))):
        assert np.abs(got - want).max() <= gtol * np.abs(want).max()


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("b", [3, 12])
def test_layers_step_plain_version_matches_pallas_at_beam_rows(dt, b):
    """Beam-like row counts (a beam of 3, of 12) at E = 128, 2 layers."""
    idx, l_view, heads = 9, 16, 4
    w, step = _stack_data(b, 128, heads, 256, 2, idx, seed=40 + b)
    tol = dict(atol=1e-4, rtol=1e-4) if dt == F32 else dict(atol=8e-2, rtol=0)
    norms = set(dk._NORM_KEYS)
    tw = {k: t.clone() if k in norms else t.to(dt) for k, t in w.items()}
    jw = {k: jnp.asarray(t.numpy()) if k in norms else jnp.asarray(t.numpy()).astype(JDT[dt])
          for k, t in w.items()}
    ts = [t.clone() if i == 5 else t.to(dt) for i, t in enumerate(step)]
    js = [jnp.asarray(t.numpy()) if i == 5 else jnp.asarray(t.numpy()).astype(JDT[dt])
          for i, t in enumerate(step)]
    x_j, k_j, v_j = jpd.fused_layers_step(*js, jw, idx, heads=heads, block_b=b, l_view=l_view,
                                          interpret=True)
    x_t, k_t, v_t = dk.fused_layers_step_reference(*ts, tw, idx, heads=heads, l_view=l_view)
    for got, want in ((x_t, x_j), (k_t, k_j), (v_t, v_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jnp.asarray(want, jnp.float32)), **tol)
