"""The fused LM-head + SCE loss of the port against ``vct_tpu.ops.fused_loss``
and the Pallas kernels of ``vct_tpu.ops.pallas_loss`` in interpret mode, on
the same numpy inputs (N=300, E=128, V=1111: a ragged last row tile and a
partial last vocab tile).

On the CPU the port's wrappers run their kernels' plain versions; these tests
hold those plain versions to the reference kernels, and the card tests
(``test_torch_port_cuda.py``) hold the CUDA kernels to the plain versions.

Tolerances. float32: both sides accumulate each logit in float32 in a
different order, so per-row statistics agree to 1e-5 relative and gradients
to 1e-5 of their largest value. bfloat16: a logit whose float32 sum sits on
a rounding boundary may round to the neighbouring bfloat16 value on one side;
dz then moves by up to 3% at that element, and one such element smears a
weight column over a dx row. Elementwise, dz agrees within one bfloat16 unit
(2**-7 relative) for all but 0.1% of the elements; dx/dwg/dbg agree to 5e-3
of their largest value, the bound the reference's own kernel-vs-scan test
uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vct_tpu.ops import fused_loss as jfl
from vct_tpu.ops import pallas_loss as jpl
from vct_tpu_torch.ops import fused_loss as fl
from vct_tpu_torch.ops import loss_kernels as lk

N, E, V = 300, 128, 1111
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _data(seed=0, n=N, v=V):
    """x, wg [E, V] (the reference's layout), bg, labels, keep, m as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, E)).astype(np.float32)
    wg = (rng.standard_normal((E, v)) * 0.05).astype(np.float32)
    bg = (rng.standard_normal((v,)) * 0.01).astype(np.float32)
    labels = rng.integers(1, v, (n,)).astype(np.int32)
    labels[rng.random(n) < 0.2] = 0
    labels[:3] = v - 1  # in the last, partial vocab tile
    keep = (rng.random(n) > 0.25).astype(np.float32)
    m = (rng.random(n) > 0.15).astype(np.float32)
    keep[5:9] = 0.0  # rows with no weight in either term
    m[5:9] = 0.0
    return x, wg, bg, labels, keep, m


def _port_args(data, dt):
    x, wg, bg, labels, keep, m = data
    w, b = lk.pad_generator(torch.tensor(wg.T.copy()), torch.tensor(bg), dt)
    return torch.tensor(x).to(dt), w, b, torch.tensor(labels)


def _ref_args(data, dt, bwd=False):
    x, wg, bg, labels, _, _ = data
    return jfl._pallas_pad_args(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(bg),
                                jnp.asarray(labels), JDT[dt], bwd=bwd)


def _col(vec, n_pad):
    return jnp.pad(jnp.asarray(vec, jnp.float32), (0, n_pad - len(vec)))[:, None]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_forward_kernels_match_pallas_interpret(dt):
    data = _data()
    x, w, b, labels = _port_args(data, dt)
    x_p, w_dt, b_dt, lab_p, block_n, n_pad = _ref_args(data, dt)
    m_j, s_j, zt_j = jpl.softmax_stats(x_p, w_dt, b_dt, lab_p, block_n=block_n,
                                       block_v=512, interpret=True)
    m, s, zt = lk.softmax_stats(x, w, b, labels)
    lse_j = np.asarray(m_j + jnp.log(s_j))[:N, 0]
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=0, atol=2e-3)
    np.testing.assert_allclose(_np(m + torch.log(s)), lse_j, **tol)
    # the label logit is one logits value: a bfloat16 unit at |z| < 2 is 2**-7
    np.testing.assert_allclose(_np(zt), np.asarray(zt_j)[:N, 0],
                               **(tol if dt == torch.float32 else dict(rtol=0, atol=2 ** -7)))
    lse = torch.tensor(lse_j)
    sa_j, cnt_j = jpl.clipped_prob_stats(x_p, w_dt, b_dt, _col(lse_j, n_pad),
                                         block_n=block_n, block_v=512, interpret=True)
    sa, cnt = lk.clipped_prob_stats(x, w, b, lse)
    np.testing.assert_allclose(_np(sa), np.asarray(sa_j)[:N, 0], **tol)
    np.testing.assert_allclose(_np(cnt), np.asarray(cnt_j)[:N, 0], rtol=0, atol=0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_backward_kernel_matches_pallas_interpret(dt):
    data = _data(seed=1)
    rng = np.random.default_rng(11)
    x, w, b, labels = _port_args(data, dt)
    m, s, _ = lk.softmax_stats(x, w, b, labels)
    lse = (m + torch.log(s)).numpy()
    u, cc, lt = (rng.random(N).astype(np.float32) * 1e-2 for _ in range(3))
    u[5:9] = cc[5:9] = lt[5:9] = 0.0
    x_p, w_dt, b_dt, lab_p, block_n, n_pad = _ref_args(data, dt, bwd=True)
    dx_j, dz_j, parts_j = jpl.sce_backward_tiles(
        x_p, w_dt, b_dt, _col(lse, n_pad), _col(u, n_pad), _col(cc, n_pad), _col(lt, n_pad),
        lab_p, block_n=block_n, block_v=512, interpret=True)
    dx, dz, parts = lk.sce_backward_tiles(x, w, b, *(torch.tensor(a) for a in (lse, u, cc, lt)),
                                          labels)
    assert dz.dtype == dt and dx.dtype == torch.float32
    assert parts.shape == ((N + lk.ROW_TILE[dt] - 1) // lk.ROW_TILE[dt], w.shape[0])
    dz_ref = np.asarray(dz_j.astype(jnp.float32))[:N]
    err = np.abs(_np(dz) - dz_ref)
    if dt == torch.float32:
        assert (err <= 1e-5 * np.abs(dz_ref) + 1e-9).all()
        gtol = 1e-5
    else:
        assert (err > 2.0 ** -7 * np.abs(dz_ref) + 1e-12).mean() < 1e-3
        assert (err <= 0.05 * np.abs(dz_ref) + 1e-12).all()
        gtol = 5e-3
    assert not _np(dz)[5:9].any()  # zero-weight rows contribute exactly nothing
    for got, want in ((dx, np.asarray(dx_j)[:N]),
                      (parts.sum(0), np.asarray(parts_j)[::8].sum(0))):
        assert np.abs(_np(got) - want).max() <= gtol * np.abs(want).max()


def _ref_value_and_grads(data, dt, use_pallas, with_rce, block_v=256):
    x, wg, bg, labels, keep, m = (jnp.asarray(a) for a in data)

    def loss(x, wg, bg):
        c, cn, r, rn = jfl.linear_sce_parts(x, wg, bg, labels, keep, m, JDT[dt], block_v,
                                            with_rce, False, use_pallas)
        return 0.7 * c / jnp.maximum(cn, 1.0) + 1.3 * r / jnp.maximum(rn, 1.0), (c, cn, r, rn)

    (_, parts), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, wg, bg)
    return [float(p) for p in parts], [np.asarray(g) for g in grads]


def _port_value_and_grads(data, dt, use_kernels, with_rce, block_v=256):
    x, wg, bg, labels, keep, m = data
    leaves = [torch.tensor(x).requires_grad_(), torch.tensor(wg.T.copy()).requires_grad_(),
              torch.tensor(bg).requires_grad_()]
    parts = fl.linear_sce_parts(*leaves, torch.tensor(labels), torch.tensor(keep),
                                torch.tensor(m), dt, block_v, with_rce, use_kernels)
    (0.7 * parts[0] / parts[1].clamp(min=1.0)
     + 1.3 * parts[2] / parts[3].clamp(min=1.0)).backward()
    dx, dwg, dbg = (t.grad.numpy() for t in leaves)
    return [float(p) for p in parts], [dx, dwg.T, dbg]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["kernel", "chunked"])
@pytest.mark.parametrize("with_rce", [True, False])
def test_linear_sce_parts_matches_reference_on_both_routes(monkeypatch, dt, route, with_rce):
    """Values and dx/dwg/dbg against jax.grad of the reference: the kernel
    route against the Pallas kernels in interpret mode, the chunked route
    against the reference's scans."""
    kernel = route == "kernel"
    monkeypatch.setattr(jfl, "_INTERPRET", kernel)
    monkeypatch.setattr(fl, "KERNEL_ROUTE_ON_CPU", kernel)
    data = _data(seed=2)
    assert fl._kernel_ok(True, torch.zeros(N, E), torch.zeros(V, E), dt) == kernel
    want_parts, want_grads = _ref_value_and_grads(data, dt, kernel, with_rce)
    got_parts, got_grads = _port_value_and_grads(data, dt, kernel, with_rce)
    vtol, gtol = (1e-5, 1e-5) if dt == torch.float32 else (2e-4, 5e-3)
    np.testing.assert_allclose(got_parts, want_parts, rtol=vtol)
    if not with_rce:
        assert got_parts[2] == 0.0 and got_parts[3] == 0.0
    for name, g, w in zip(("dx", "dwg", "dbg"), got_grads, want_grads):
        assert np.abs(g - w).max() <= gtol * max(np.abs(w).max(), 1e-8), name


def test_routes_agree_and_labels_masks_get_no_gradient(monkeypatch):
    data = _data(seed=3)
    monkeypatch.setattr(fl, "KERNEL_ROUTE_ON_CPU", True)
    a_parts, a_grads = _port_value_and_grads(data, torch.float32, True, True)
    b_parts, b_grads = _port_value_and_grads(data, torch.float32, False, True, block_v=2048)
    np.testing.assert_allclose(a_parts, b_parts, rtol=1e-5)
    for g, w in zip(a_grads, b_grads):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    x, wg, bg, labels, keep, m = data
    keep_t = torch.tensor(keep).requires_grad_()
    m_t = torch.tensor(m).requires_grad_()
    parts = fl.linear_sce_parts(torch.tensor(x).requires_grad_(), torch.tensor(wg.T.copy()),
                                torch.tensor(bg), torch.tensor(labels), keep_t, m_t)
    (parts[0] + parts[2]).backward()
    assert keep_t.grad is None and m_t.grad is None
    assert not parts[1].requires_grad and not parts[3].requires_grad


@pytest.mark.parametrize("n,e,v,dt,ok", [
    (300, 128, 1111, torch.bfloat16, True),
    (255, 128, 1111, torch.float32, False),    # too few rows
    (4097, 128, 1111, torch.float32, False),   # past the row window
    (300, 96, 1111, torch.float32, False),     # width not a multiple of 128
    (300, 1024, 1111, torch.float32, True),    # no cap on the width, as in the reference
    (300, 128, 1000, torch.float32, False),    # vocab under two tiles
    (300, 128, 1111, torch.float16, False),
])
def test_kernel_route_eligibility(monkeypatch, n, e, v, dt, ok):
    monkeypatch.setattr(fl, "KERNEL_ROUTE_ON_CPU", True)
    assert fl._kernel_ok(True, torch.zeros(n, e), torch.zeros(v, e), dt) == ok
    assert not fl._kernel_ok(False, torch.zeros(n, e), torch.zeros(v, e), dt)
    monkeypatch.setattr(fl, "KERNEL_ROUTE_ON_CPU", False)
    assert not fl._kernel_ok(True, torch.zeros(n, e), torch.zeros(v, e), dt)


def test_pad_generator_pads_with_zero_rows_and_neg_inf_bias():
    wg, bg = torch.randn(V, E), torch.randn(V)
    w, b = lk.pad_generator(wg, bg, torch.bfloat16)
    assert w.shape == (1536, E) and b.shape == (1536,) and w.dtype == torch.bfloat16
    assert torch.equal(w[:V], wg.to(torch.bfloat16)) and not w[V:].any()
    assert bool((b[V:].float() < -9e29).all())


def test_wrappers_refuse_other_devices():
    x = torch.zeros(4, E, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        lk.softmax_stats(x, x, x, x)
