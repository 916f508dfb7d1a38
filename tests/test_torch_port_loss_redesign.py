"""What the redesigned statistics kernels of the fused loss rest on that a CPU
can check: the generator goes to the kernels as it is (no padded copy), the
plain versions mask the ragged last vocab tile as the kernels do, and the
pure-Python launch plan ``sce_stats_plan`` mirrors the C launcher of
``softmax_stats`` / ``clipped_prob_stats`` (``csrc/sce_loss.cu``). The card
tests (``test_torch_port_cuda.py``) hold the plan against what the launcher
reports and the kernels against their plain versions. Also: the config
options of the reference that the port ignores are named once, at load.

Tolerances: as in ``test_torch_port_fused_loss.py`` (float32 1e-5; bfloat16
2e-4 on the loss parts and 5e-3 of the largest gradient).
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.ops import fused_loss as jfl
from vct_tpu_torch.cli import common
from vct_tpu_torch.ops import fused_loss as fl
from vct_tpu_torch.ops import loss_kernels as lk

N, E, V = 100, 128, 1111
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SMEM_LIMIT = 232448  # what one block may have on an H100


def _generator(seed=0, n=N, v=V):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, E)).astype(np.float32)
    wg = (rng.standard_normal((v, E)) * 0.05).astype(np.float32)
    bg = (rng.standard_normal((v,)) * 0.01).astype(np.float32)
    labels = rng.integers(0, v, (n,)).astype(np.int32)
    labels[:3] = v - 1  # in the last, partial vocab tile
    return x, wg, bg, labels


# ---------------------------------------------------------------------------
# the generator as it is
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_versions_give_the_same_bits_on_padded_and_bare_generators(dt):
    """A short last tile read as zero rows with a NEG_INF bias is what the
    padded generator held: every output is the same, bit for bit."""
    x, wg, bg, labels = _generator()
    x = torch.tensor(x).to(dt)
    lab = torch.tensor(labels)
    bare = (torch.tensor(wg).to(dt), torch.tensor(bg).to(dt))
    padded = lk.pad_generator(torch.tensor(wg), torch.tensor(bg), dt)
    assert bare[0].shape[0] == V and padded[0].shape[0] == 1536
    outs = []
    for w, b in (bare, padded):
        m, s, zt = lk.softmax_stats_reference(x, w, b, lab)
        lse = m + torch.log(s)
        sa, cnt = lk.clipped_prob_stats_reference(x, w, b, lse)
        rng = np.random.default_rng(1)
        u, cc, lt = (torch.tensor(rng.random(N).astype(np.float32) * 1e-2) for _ in range(3))
        dx, dz, parts = lk.sce_backward_tiles_reference(x, w, b, lse, u, cc, lt, lab)
        outs.append((m, s, zt, sa, cnt, dx, dz, parts))
    for name, a, b in zip(("m", "s", "zt", "sa", "cnt", "dx", "dz", "dbg_parts"), *outs):
        assert a.shape == b.shape and torch.equal(a, b), name
    assert not outs[0][6][:, V:].float().any()  # dz past V is zero
    assert not outs[0][7][:, V:].any()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["kernel", "chunked"])
def test_linear_sce_parts_never_pads_and_matches_the_reference(monkeypatch, dt, route):
    """Both routes at a ragged vocab (V=1111) with ``pad_generator`` made to
    fail: the kernel route's plain versions take the bare generator. Held to
    the reference's scans (``vct_tpu.ops.fused_loss``) within the tolerances
    of ``test_torch_port_fused_loss.py``."""
    def no_pad(*_):
        raise AssertionError("pad_generator ran on linear_sce_parts' path")

    monkeypatch.setattr(lk, "pad_generator", no_pad)
    monkeypatch.setattr(fl, "KERNEL_ROUTE_ON_CPU", route == "kernel")
    n = 300
    x, wg, bg, labels = _generator(seed=4, n=n)
    rng = np.random.default_rng(5)
    keep = (rng.random(n) > 0.25).astype(np.float32)
    m = (rng.random(n) > 0.15).astype(np.float32)
    assert fl._kernel_ok(True, torch.zeros(n, E), torch.zeros(V, E), dt) == (route == "kernel")

    def ref_loss(x, wg, bg):
        c, cn, r, rn = jfl.linear_sce_parts(x, wg, bg, jnp.asarray(labels), jnp.asarray(keep),
                                            jnp.asarray(m), JDT[dt], 256, True, False, False)
        return 0.7 * c / jnp.maximum(cn, 1.0) + 1.3 * r / jnp.maximum(rn, 1.0), (c, cn, r, rn)

    import jax
    (_, want), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(wg.T.copy()), jnp.asarray(bg))
    before = [fn.launches for fn in lk.WRAPPERS]
    leaves = [torch.tensor(x).requires_grad_(), torch.tensor(wg).requires_grad_(),
              torch.tensor(bg).requires_grad_()]
    got = fl.linear_sce_parts(*leaves, torch.tensor(labels), torch.tensor(keep), torch.tensor(m),
                              dt, 256, True, True)
    (0.7 * got[0] / got[1].clamp(min=1.0) + 1.3 * got[2] / got[3].clamp(min=1.0)).backward()
    assert [fn.launches for fn in lk.WRAPPERS] == before  # plain versions count nothing
    vtol, gtol = (1e-5, 1e-5) if dt == torch.float32 else (2e-4, 5e-3)
    np.testing.assert_allclose([float(t) for t in got], [float(t) for t in want], rtol=vtol)
    got_g = [leaves[0].grad.numpy(), leaves[1].grad.numpy().T, leaves[2].grad.numpy()]
    for name, g, w in zip(("dx", "dwg", "dbg"), got_g, want_g):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= gtol * max(np.abs(w).max(), 1e-8), name


# ---------------------------------------------------------------------------
# the launch plan of the statistics kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [128, 768, 896, 1664])
@pytest.mark.parametrize("n", [1, 31, 256, 1984, 4096, 7936])
def test_stats_plan_routes_covers_and_fills_the_card(n, e, dtype):
    """bfloat16 takes the tensor-core kernel at every width the wrappers
    admit (none goes to the old kernel by the rule); its tiles cover the rows
    and the ragged vocab, and from N=256 on (the kernel route's window and
    the N=7936 reading) there is a tile for every SM. float32 keeps
    ``stats_kernel``: one block per row tile walking the whole vocab."""
    v = 30522
    plan = lk.sce_stats_plan(n, e, v, dtype)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.row_tiles * plan.rows >= n > (plan.row_tiles - 1) * plan.rows
    if dtype == torch.bfloat16:
        assert plan.route == 1
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (128, lk.SLAB_V, 64, 4)
        assert plan.slabs * plan.cols >= v > (plan.slabs - 1) * plan.cols
        assert plan.grid == min(plan.row_tiles * plan.slabs, lk.H100_SMS)
        if n >= 256:
            assert plan.grid == lk.H100_SMS
        # alignment slack, four stages of 128 x rows and 128 x cols swizzled
        # bytes, and two slabs of bfloat16 bias
        assert plan.smem_bytes == 1024 + 4 * (128 + 256) * 128 + 2 * 256 * 2
    else:
        assert plan.route == 0
        assert (plan.rows, plan.cols, plan.slabs) == (16, lk.BLOCK_V, 1)
        assert plan.grid == plan.row_tiles
    # the kernel the tensor-core one replaced stays reachable for bfloat16
    old = lk.sce_stats_plan(n, e, v, dtype, route=0)
    assert old.route == 0 and old.rows == lk.ROW_TILE[dtype] and old.grid == old.row_tiles


def test_stats_plan_at_the_train_steps_shapes():
    """The MSVD step (64 x 31 rows) and the long step (4096 rows)."""
    assert lk.sce_stats_plan(1984, 768, 30522, torch.bfloat16) == lk.StatsPlan(
        1, 128, 256, 64, 4, 198656, 16, 120, 132)
    assert lk.sce_stats_plan(4096, 768, 30522, torch.bfloat16).row_tiles == 32
    # a padded generator has more slabs, and one more SM count caps the grid
    assert lk.sce_stats_plan(1984, 768, 30720, torch.bfloat16).slabs == 120
    assert lk.sce_stats_plan(100, 768, 30722, torch.bfloat16, sms=114).grid == 114
    assert lk.sce_stats_plan(1984, 768, 30522, torch.bfloat16, route=0) == lk.StatsPlan(
        0, 32, 512, 32, 2, 32 * 776 * 2 + 32 * 520 * 2 + 2 * 512 * 40 * 2 + 8192 + 640, 62, 1,
        62)


@pytest.mark.parametrize("n,e,v,dtype,route,error", [
    (0, 768, 30522, torch.bfloat16, -1, ValueError),
    (4, 100, 30522, torch.bfloat16, -1, ValueError),   # not a multiple of 128
    (4, 768, 0, torch.bfloat16, -1, ValueError),
    (4, 768, 30522, torch.float16, -1, TypeError),
    (4, 768, 30522, torch.float32, 1, ValueError),     # no tensor-core route in float32
    (4, 768, 30522, torch.bfloat16, 2, ValueError),
    (4, 1792, 30522, torch.float32, -1, ValueError),   # x's row tile no longer fits
])
def test_stats_plan_refuses(n, e, v, dtype, route, error):
    with pytest.raises(error):
        lk.sce_stats_plan(n, e, v, dtype, route)


# ---------------------------------------------------------------------------
# config options the port ignores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", common.IGNORED_TPU_OPTIONS)
def test_ignored_tpu_option_is_named_once_at_load(tmp_path, option):
    with open("configs/msvd.json") as f:
        raw = json.load(f)
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps(raw))
    raw["tpu"][option] = True
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = common.load_config(str(path))
        common.load_config(str(plain))
    assert getattr(cfg.tpu, option) is True
    assert common.ignored_options(cfg) == [f"tpu.{option}"]
    assert len(caught) == 1 and f"tpu.{option}" in str(caught[0].message)
    assert "ignores it" in str(caught[0].message)
