"""The two opt-in greedy modes of the port against ``vct_tpu``, in float32 on
the CPU: ``fused_multi_step`` (u tokens per launch) and
``fused_sequence_decode`` (the whole caption per launch), on their plain
versions, against the Pallas kernels in interpret mode; then
``greedy_generate_multi`` and ``greedy_generate_fused``'s options against
their JAX counterparts.

Tokens must be equal, except where a row's first difference falls on a
near-tie (top-2 logit gap below 1e-4, the triage rule of
``tests/test_torch_port_decode.py``); cache rows agree to 1e-4 (summation
order over a few layers, and the reference kernel's rational erf).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vct_tpu.decode_fast import _prep_decode as jax_prep
from vct_tpu.decode_fast import greedy_generate_fused as jax_greedy_fused
from vct_tpu.decode_fast import greedy_generate_multi as jax_greedy_multi
from vct_tpu.ops import pallas_decode as ref
from vct_tpu_torch.decode import make_auto_greedy_fn
from vct_tpu_torch.decode_fast import (
    _prep_decode,
    extract_fast_weights,
    greedy_generate_fused,
    greedy_generate_multi,
    layers_step_per_layer,
)
from vct_tpu_torch.ops import decode_kernels as dk

from tests.test_torch_port_decode import assert_same_tokens
from tests.test_torch_port_modules import B, build_pair, make_inputs, to_jax, to_torch

MAX_LEN = 10
L_PAD = 16
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair3():
    return build_pair(dec_layers=3)


def _prepped(pair):
    """Both packages' kernel weights and cross K/V for one batch."""
    jm, variables, pm = pair
    feats, masks = make_inputs()
    jfw, jck, jcv, jmb = jax_prep(jm, variables, to_jax(feats), to_jax(masks),
                                  max_len=MAX_LEN, block_v=128)
    fw, cks, cvs, mem_bias = _prep_decode(pm, to_torch(feats), to_torch(masks), MAX_LEN, None)
    return (jm, jfw, jck, jcv, jmb), (pm, fw, cks, cvs, mem_bias), (feats, masks)


def _jax_window(jside, cur, ks, vs, w_idx, u, l_view):
    jm, jfw, jck, jcv, jmb = jside
    e = jm.config.embed_dim
    pe3 = jfw["pe"][:L_PAD].reshape(L_PAD, 1, e)
    return ref.fused_multi_step(
        jnp.asarray(cur), ks, vs, jck, jcv, jmb, jfw["emb"], pe3, jfw,
        jnp.asarray(w_idx, jnp.int32), heads=jfw["heads"], unroll=u, block_b=B,
        pad_id=0, l_view=l_view, interpret=True)


@pytest.mark.parametrize("u", [2, 4])
def test_multi_step_reference_matches_jax_kernel(pair3, u):
    """Two consecutive windows: the raw argmax chains, and the cache rows
    each window writes."""
    jside, (pm, fw, cks, cvs, mem_bias), (feats, masks) = _prepped(pair3)
    nl, _, b, e = cks.shape
    jks = jvs = jnp.zeros((nl, L_PAD, b, e), jnp.float32)
    ks, vs = torch.zeros((nl, L_PAD, b, e)), torch.zeros((nl, L_PAD, b, e))
    cur = np.full((b,), 2, np.int32)
    chain_t, chain_j = [], []
    for w in range(2):
        tj, jks, jvs = _jax_window(jside, cur, jks, jvs, w, u, 8)
        before = dk.fused_multi_step.launches
        tt, ks, vs = dk.fused_multi_step(torch.tensor(cur), ks, vs, cks, cvs, mem_bias,
                                         fw["emb"], fw["pe"], fw, w, heads=fw["heads"],
                                         unroll=u, pad_id=0, l_view=8)
        assert dk.fused_multi_step.launches == before  # the plain version ran
        assert tt.dtype == torch.int32 and tt.shape == (b, u)
        rows = slice(w * u, w * u + u)
        np.testing.assert_allclose(ks[:, rows].numpy(), np.asarray(jks)[:, rows], **TOL)
        np.testing.assert_allclose(vs[:, rows].numpy(), np.asarray(jvs)[:, rows], **TOL)
        assert not ks[:, w * u + u:].any()  # later rows are untouched
        chain_t.append(tt)
        chain_j.append(np.asarray(tj))
        cur = np.asarray(tj)[:, -1]
    start = np.full((b, 1), 2, np.int32)
    got = torch.cat([torch.tensor(start)] + chain_t, dim=1)
    want = np.concatenate([start] + chain_j, axis=1)
    assert_same_tokens(pm, feats, masks, got, want)


def test_multi_step_window_outside_l_view_is_poisoned(pair3):
    jside, (pm, fw, cks, cvs, mem_bias), _ = _prepped(pair3)
    nl, _, b, e = cks.shape
    cur = np.full((b,), 2, np.int32)

    def window(w_idx):
        jks = jnp.zeros((nl, L_PAD, b, e), jnp.float32)
        tj, _, _ = _jax_window(jside, cur, jks, jks, w_idx, 4, 8)
        tt, _, _ = dk.fused_multi_step(
            torch.tensor(cur), torch.zeros((nl, L_PAD, b, e)),
            torch.zeros((nl, L_PAD, b, e)), cks, cvs, mem_bias, fw["emb"], fw["pe"], fw,
            w_idx, heads=fw["heads"], unroll=4, pad_id=0, l_view=8)
        return np.asarray(tj), tt.numpy()

    tj, tt = window(1)  # (1 + 1) * 4 = 8 <= l_view: real tokens
    assert (tj >= 0).all() and (tt >= 0).all()
    tj, tt = window(2)  # (2 + 1) * 4 = 12 > l_view: poisoned
    assert (tj == -1).all() and (tt == -1).all()


def test_multi_step_refuses_an_unroll_that_does_not_tile(pair3):
    _, (pm, fw, cks, cvs, mem_bias), _ = _prepped(pair3)
    nl, _, b, e = cks.shape
    ks = torch.zeros((nl, L_PAD, b, e))
    cur = torch.full((b,), 2, dtype=torch.int32)
    for u, l_view in ((3, 8), (4, 6), (0, 8)):
        with pytest.raises(ValueError, match="unroll"):
            dk.fused_multi_step(cur, ks, ks.clone(), cks, cvs, mem_bias, fw["emb"], fw["pe"],
                                fw, 0, heads=fw["heads"], unroll=u, l_view=l_view)


@pytest.mark.parametrize("early", [False, True])
def test_sequence_decode_reference_matches_jax_kernel(pair3, early):
    jside, (pm, fw, cks, cvs, mem_bias), (feats, masks) = _prepped(pair3)
    jm, jfw, jck, jcv, jmb = jside

    def jax_seq(end_id):
        return np.asarray(ref.fused_sequence_decode(
            jfw["emb"], jfw["pe"], jck, jcv, jmb, jfw, heads=jfw["heads"], max_len=MAX_LEN,
            start_id=2, end_id=end_id, pad_id=0, interpret=True))

    want = jax_seq(-1)
    end_id = -1
    if early:
        # row 0's token at position 2: at least that row finishes early
        end_id = int(want[0, 2])
        want = jax_seq(end_id)
    before = dk.fused_sequence_decode.launches
    got = dk.fused_sequence_decode(fw["emb"], fw["pe"], cks, cvs, mem_bias, fw,
                                   heads=fw["heads"], max_len=MAX_LEN, start_id=2,
                                   end_id=end_id, pad_id=0)
    assert dk.fused_sequence_decode.launches == before
    assert got.dtype == torch.int32 and got.shape == (B, MAX_LEN)
    assert_same_tokens(pm, feats, masks, got, want)


def test_sequence_decode_pads_once_every_row_has_finished():
    """A generator biased to the end token: every row finishes at step 1 and
    both implementations leave [PAD] in the remaining positions."""
    jm, variables, pm = build_pair()
    with torch.no_grad():
        pm.cap_decoder.generator.bias[5] = 1e3
    variables["params"]["cap_decoder"]["generator"]["bias"][5] = 1e3
    feats, masks = make_inputs()
    expected = [[2, 5] + [0] * (MAX_LEN - 2)] * B
    want, _ = jax_greedy_fused(jm, variables, to_jax(feats), to_jax(masks), max_len=MAX_LEN,
                               start_id=2, end_id=5, block_v=128, sequence_kernel=True,
                               interpret=True)
    assert np.asarray(want).tolist() == expected
    for kw in (dict(sequence_kernel=True), dict(multi_step=2), dict(multi_step=4)):
        got, _ = greedy_generate_fused(pm, to_torch(feats), to_torch(masks),
                                       max_len=MAX_LEN, start_id=2, end_id=5, **kw)
        assert got.tolist() == expected, kw


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("u", [2, 4])
def test_greedy_multi_matches_reference(pair3, u, early):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    kw = dict(max_len=MAX_LEN, start_id=2)
    want, _ = jax_greedy_multi(jm, variables, to_jax(feats), to_jax(masks), end_id=-1,
                               unroll=u, block_b=B, block_v=128, interpret=True, **kw)
    end_id = -1
    if early:
        end_id = int(np.asarray(want)[1, 3])
        want, _ = jax_greedy_multi(jm, variables, to_jax(feats), to_jax(masks),
                                   end_id=end_id, unroll=u, block_b=B, block_v=128,
                                   interpret=True, **kw)
    got, _ = greedy_generate_multi(pm, to_torch(feats), to_torch(masks), end_id=end_id,
                                   unroll=u, **kw)
    assert got.dtype == torch.int32 and got.shape == (B, MAX_LEN)
    assert_same_tokens(pm, feats, masks, got, want)
    # and the port's own per-token loop gives the same tokens
    loop, _ = greedy_generate_fused(pm, to_torch(feats), to_torch(masks), end_id=end_id, **kw)
    np.testing.assert_array_equal(got.numpy(), loop.numpy())


@pytest.mark.parametrize("kw", [dict(multi_step=2), dict(multi_step=4),
                                dict(sequence_kernel=True)])
def test_greedy_fused_options_match_reference(pair3, kw):
    jm, variables, pm = pair3
    feats, masks = make_inputs(seed=1)
    want, _ = jax_greedy_fused(jm, variables, to_jax(feats), to_jax(masks), max_len=MAX_LEN,
                               start_id=2, end_id=-1, block_v=128, interpret=True, **kw)
    got, _ = greedy_generate_fused(pm, to_torch(feats), to_torch(masks), max_len=MAX_LEN,
                                   start_id=2, end_id=-1, fw=extract_fast_weights(pm), **kw)
    assert_same_tokens(pm, feats, masks, got, want)


def test_exclusive_options_raise_like_the_reference(pair3):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    tf, tm = to_torch(feats), to_torch(masks)
    for kw, match in ((dict(multi_step=2, sequence_kernel=True), "exclusive"),
                      (dict(multi_step=2, single_kernel=True), "exclusive"),
                      (dict(sequence_kernel=True, single_kernel=True), "do(es)? not apply")):
        with pytest.raises(ValueError, match=match):
            greedy_generate_fused(pm, tf, tm, max_len=MAX_LEN, **kw)
        with pytest.raises(ValueError, match=match):
            jax_greedy_fused(jm, variables, to_jax(feats), to_jax(masks), max_len=MAX_LEN,
                             interpret=True, **kw)
    with pytest.raises(ValueError, match="unroll"):
        greedy_generate_multi(pm, tf, tm, max_len=MAX_LEN, unroll=3)
    wide = [torch.zeros((33,) + tf[0].shape[1:])]
    with pytest.raises(ValueError, match="B <= 32"):
        greedy_generate_fused(pm, wide, None, max_len=MAX_LEN, sequence_kernel=True)


def test_per_layer_stack_gives_the_stack_kernels_tokens(pair3):
    """A greedy decode whose stack runs one ``fused_layer_step`` per layer
    (``layers_step_per_layer``) gives the tokens of the two-kernel path."""
    _, _, pm = pair3
    feats, masks = make_inputs(seed=3)
    tf, tm = to_torch(feats), to_torch(masks)
    want, _ = greedy_generate_fused(pm, tf, tm, max_len=MAX_LEN, start_id=2, end_id=-1,
                                    single_kernel=False)
    fw, cks, cvs, mem_bias = _prep_decode(pm, tf, tm, MAX_LEN, None)
    nl, _, b, e = cks.shape
    ks, vs = torch.zeros((nl, L_PAD, b, e)), torch.zeros((nl, L_PAD, b, e))
    tokens = torch.zeros((b, MAX_LEN), dtype=torch.int32)
    tokens[:, 0] = 2
    for i in range(MAX_LEN - 1):
        x = dk._embed_step(fw["emb"], fw["pe"], tokens[:, i], i, 0)
        x, ks, vs = layers_step_per_layer(x, ks, vs, cks, cvs, mem_bias, fw["stacked"], i,
                                          heads=fw["heads"])
        tokens[:, i + 1] = dk.fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"],
                                                          fw["wg"], fw["bg"])
    np.testing.assert_array_equal(tokens.numpy(), want.numpy())


def test_auto_dispatch_never_picks_the_opt_in_modes(pair3, monkeypatch):
    import vct_tpu_torch.decode_fast as df

    def refuse(*a, **k):
        raise AssertionError("an opt-in kernel ran on the auto path")

    monkeypatch.setattr(df, "fused_multi_step", refuse)
    monkeypatch.setattr(df, "fused_sequence_decode", refuse)
    _, _, pm = pair3
    feats, masks = make_inputs()
    tokens, _ = make_auto_greedy_fn(pm, MAX_LEN, 2, -1)(to_torch(feats), to_torch(masks))
    assert tokens.shape == (B, MAX_LEN)
