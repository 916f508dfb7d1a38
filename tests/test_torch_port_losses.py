"""The port's caption losses against ``vct_tpu.models.losses`` on the same
numpy inputs. Both sides compute in float32 whatever the logits' dtype, so
the parts agree to float-summation order: rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vct_tpu.models import losses as jl
from vct_tpu_torch.models import losses as pl

N, V = 96, 211
RTOL = 1e-5


def _data(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((N, V)) * 3).astype(dtype)
    labels = rng.integers(1, V, (N,)).astype(np.int32)
    labels[rng.random(N) < 0.25] = 0
    rect = rng.random(N) > 0.2
    valid = rng.random(N) > 0.1
    return logits, labels, rect, valid


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("use_valid", [False, True])
def test_cross_entropy_parts_match_reference(use_valid):
    logits, labels, _, valid = _data(0)
    valid = valid if use_valid else None
    want = jl.cross_entropy_parts(_j(logits), _j(labels), 0, _j(valid))
    got = pl.cross_entropy_parts(_t(logits), _t(labels), 0, _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)
    np.testing.assert_allclose(
        float(pl.cross_entropy(_t(logits), _t(labels), 0, _t(valid))),
        float(jl.cross_entropy(_j(logits), _j(labels), 0, _j(valid))), rtol=RTOL)


@pytest.mark.parametrize("use_rect,use_valid", [(False, False), (True, False), (True, True)])
def test_sce_loss_parts_match_reference(use_rect, use_valid):
    logits, labels, rect, valid = _data(1)
    rect = rect if use_rect else None
    valid = valid if use_valid else None
    want = jl.sce_loss_parts(_j(logits), _j(labels), ignore_index=0, rect_mask=_j(rect),
                             valid=_j(valid))
    got = pl.sce_loss_parts(_t(logits), _t(labels), ignore_index=0, rect_mask=_t(rect),
                            valid=_t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)
    np.testing.assert_allclose(
        float(pl.sce_loss(_t(logits), _t(labels), alpha=0.5, beta=0.5, rect_mask=_t(rect),
                          valid=_t(valid))),
        float(jl.sce_loss(_j(logits), _j(labels), alpha=0.5, beta=0.5, rect_mask=_j(rect),
                          valid=_j(valid))), rtol=RTOL)


def test_sce_loss_parts_on_bfloat16_logits_match_reference():
    """bfloat16 logits are widened to float32 on both sides: same values in."""
    logits, labels, rect, _ = _data(2)
    lj = _j(logits).astype(jnp.bfloat16)
    lt = _t(logits).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(lj.astype(jnp.float32)), lt.float().numpy())
    want = jl.sce_loss_parts(lj, _j(labels), rect_mask=_j(rect))
    got = pl.sce_loss_parts(lt, _t(labels), rect_mask=_t(rect))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def test_all_positions_ignored_gives_zero_not_nan():
    logits, labels, _, _ = _data(3)
    labels[:] = 0
    assert float(pl.cross_entropy(_t(logits), _t(labels))) == 0.0
    loss = pl.sce_loss(_t(logits), _t(labels), alpha=0.5, beta=0.5,
                       valid=_t(np.zeros(N, bool)))
    assert float(loss) == 0.0


def test_sce_gradient_matches_reference():
    import jax

    logits, labels, rect, valid = _data(4)
    lt = _t(logits).requires_grad_()
    pl.sce_loss(lt, _t(labels), alpha=0.5, beta=0.5, rect_mask=_t(rect),
                valid=_t(valid)).backward()
    want = jax.grad(lambda z: jl.sce_loss(z, _j(labels), alpha=0.5, beta=0.5,
                                          rect_mask=_j(rect), valid=_j(valid)))(_j(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-8)
