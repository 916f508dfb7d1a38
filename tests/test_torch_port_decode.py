"""Greedy tokens of the port against the JAX reference, in float32 on the CPU:
the port's module path against ``vct_tpu.decode.greedy_generate``, and the
port's kernel path (plain versions on CPU tensors) against
``vct_tpu.decode_fast.greedy_generate_fused`` in Pallas interpret mode.

Tokens must be equal, except where a row's first difference falls on a
near-tie: a top-2 logit gap below ``NEAR_TIE`` = 1e-4, about a hundred
float32 roundings at these logit magnitudes (the triage rule for decodes
that sum in different orders).
"""

import numpy as np
import pytest
import torch

from vct_tpu.decode import greedy_generate as jax_greedy
from vct_tpu.decode_fast import greedy_generate_fused as jax_greedy_fused
from vct_tpu_torch.decode import (
    detokenize_batch,
    first_mismatch_gaps,
    greedy_generate,
    make_auto_greedy_fn,
)
from vct_tpu_torch.decode_fast import greedy_generate_fused

from tests.test_torch_port_modules import B, build_pair, make_inputs, to_jax, to_torch

NEAR_TIE = 1e-4
MAX_LEN = 10


def assert_same_tokens(pm, feats, masks, got, want):
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    for row, pos, gap in first_mismatch_gaps(pm, to_torch(feats), to_torch(masks),
                                             got, want):
        assert gap < NEAR_TIE, (row, pos, gap, got[row], want[row])


@pytest.fixture(scope="module")
def pair3():
    return build_pair(dec_layers=3)


@pytest.mark.parametrize("end_row", [None, 0])
def test_module_path_matches_reference(pair3, end_row):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    want, _ = jax_greedy(jm, variables, to_jax(feats), to_jax(masks), max_len=MAX_LEN,
                         start_id=2, end_id=-1)
    end_id = -1 if end_row is None else int(np.asarray(want)[end_row, 3])
    if end_row is not None:
        want, _ = jax_greedy(jm, variables, to_jax(feats), to_jax(masks),
                             max_len=MAX_LEN, start_id=2, end_id=end_id)
    got, _ = greedy_generate(pm, to_torch(feats), to_torch(masks), max_len=MAX_LEN,
                             start_id=2, end_id=end_id)
    assert got.dtype == torch.int32 and got.shape == (B, MAX_LEN)
    assert_same_tokens(pm, feats, masks, got, want)


@pytest.mark.parametrize("single_kernel", [True, False])
def test_kernel_path_matches_reference_fused_decode(pair3, single_kernel):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    want, _ = jax_greedy_fused(jm, variables, to_jax(feats), to_jax(masks),
                               max_len=MAX_LEN, start_id=2, end_id=-1, block_b=B,
                               block_v=128, single_kernel=single_kernel,
                               interpret=True)
    got, _ = greedy_generate_fused(pm, to_torch(feats), to_torch(masks),
                                   max_len=MAX_LEN, start_id=2, end_id=-1,
                                   single_kernel=single_kernel)
    assert_same_tokens(pm, feats, masks, got, want)


def test_every_row_finished_pads_the_rest_on_both_paths():
    """A generator biased to emit token 5 at once: with end_id 5 every row
    finishes at step 1 and the remaining positions are [PAD] (id 0)."""
    jm, variables, pm = build_pair()
    with torch.no_grad():
        pm.cap_decoder.generator.bias[5] = 1e3
    variables["params"]["cap_decoder"]["generator"]["bias"][5] = 1e3
    feats, masks = make_inputs()
    want, _ = jax_greedy(jm, variables, to_jax(feats), to_jax(masks), max_len=MAX_LEN,
                         start_id=2, end_id=5)
    expected = [[2, 5] + [0] * (MAX_LEN - 2)] * B
    assert np.asarray(want).tolist() == expected
    for fn in (greedy_generate, greedy_generate_fused):
        got, _ = fn(pm, to_torch(feats), to_torch(masks), max_len=MAX_LEN,
                    start_id=2, end_id=5)
        assert got.tolist() == expected


def test_auto_dispatch(pair3):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    fused = make_auto_greedy_fn(pm, MAX_LEN, 2, -1)
    tok_f, attn_f = fused(to_torch(feats), to_torch(masks))
    assert attn_f is None
    module = make_auto_greedy_fn(pm, MAX_LEN, 2, -1, collect_attn=True)
    tok_m, attn_m = module(to_torch(feats), to_torch(masks))
    assert attn_m.shape == (MAX_LEN - 1, 3, B, 7)
    torch.testing.assert_close(attn_m.sum(-1), torch.ones(MAX_LEN - 1, 3, B))
    assert_same_tokens(pm, feats, masks, tok_f, tok_m)


def test_detokenize_batch_truncates_at_sep():
    from vct_tpu.text.tokenizer import WordPieceTokenizer

    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog", "##s", "run"])}
    tok = WordPieceTokenizer(vocab)
    ids = torch.tensor([[2, 5, 6, 7, 8, 3, 5], [2, 8, 8, 8, 8, 8, 8]], dtype=torch.int32)
    assert detokenize_batch(tok, ids) == ["a dogs run", "run run run run run"]
