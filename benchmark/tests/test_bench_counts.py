"""The operation and byte counts against hand counts at the MSVD shapes
(E=768, FF=2048, 3 decoder layers, 1 encoder layer, V=30522, 12 frame slots,
32-token captions, batch 64; and a step at 255 slots, 129 tokens, batch 32),
written out here term by term."""

from __future__ import annotations

import pytest

import tiny  # noqa: F401 (puts the benchmark on sys.path)

from benchlib import counts  # noqa: E402
from benchlib.cells import load_cell  # noqa: E402
from benchlib.weights import dims_of, spec  # noqa: E402

E, F, V, NL = 768, 2048, 30522, 3


@pytest.fixture(scope="module")
def d():
    return dims_of(load_cell("msvd-train").config)


def test_dims_are_the_published_recipe(d):
    assert (d["embed_dim"], d["decoder_ff"], d["vocab"], d["decoder_layers"]) == (E, F, V, NL)
    assert (d["encoder_layers"], d["max_frames"], d["max_caption_len"]) == (1, 12, 32)


def test_weights_cover_the_model(d):
    n = sum(int.__mul__(*s) if len(s) == 2 else s[0] for _, s, _ in spec(d))
    # unify 393,984; encoder layer 5,513,984 and norm 1,536; three decoder
    # layers 23,633,664 and norm 1,536; LM head 23,471,418; embedding
    # 23,440,896; matching head 393,728. (PERF.md's 80,297,018 is the model
    # without the matching head and with the 5000 x 768 positional buffer,
    # which the reference computes itself.)
    assert n == 76_850_746 == 80_297_018 - 5000 * 768 + 393_728


def test_train_step_flops_by_hand(d):
    enc = 2 * 64 * 12 * 512 * E + 2 * 64 * 13 * (4 * E * E + 2 * E * F) + 4 * 64 * 13 * 13 * E
    dec_layer = (2 * 64 * 31 * (6 * E * E + 2 * E * F) + 2 * 64 * 13 * 2 * E * E
                 + 4 * 64 * 31 * 31 * E + 4 * 64 * 31 * 13 * E)
    head = 2 * 64 * 31 * E * V
    want = 3 * (enc + NL * dec_layer + head)
    assert counts.train_step_flops(d, 64, 12, 32) == pytest.approx(want, rel=1e-12)
    assert 560e9 < want < 570e9  # about 561 GFLOP, the issue's cross-check


def test_long_train_step_flops(d):
    got = counts.train_step_flops(dict(d, max_frames=255, max_caption_len=129), 32, 255, 129)
    assert 1.5e12 < got < 1.7e12  # about 1.59 TFLOP a step


def test_loss_ops_by_hand(d):
    ops = counts.loss_ops(d, 64 * 31)
    assert ops["softmax_stats"] == 2 * 1984 * E * V  # 93.0 GFLOP
    assert ops["sce_backward_tiles"] == 4 * 1984 * E * V
    assert counts.bound_s(0, ops["softmax_stats"]) == pytest.approx(0.0940e-3, rel=2e-3)


def test_whole_step_bytes_by_hand(d):
    layer = 3 * E * E + 3 * E * E + 2 * E * F
    vectors = 3 * E + E + E + E + F + E + 6 * E
    weights = NL * 2 * (layer + vectors)
    cache = NL * 2 * 1 * 32 * E * 2  # position 0: one row of K and of V
    cross = NL * 2 * 13 * 32 * E * 2
    acts = 2 * 32 * E * 2 + 32 * 13 * 4
    head = V * E * 2 + V * 4 + 2 * E * 4 + 32 * E * 2 + 32 * (8 + 4)
    want = weights + cache + cross + acts + head - 2 * 32 * E * 2
    got = counts.whole_step(d, 32, 0, 13)
    assert got["bytes"] == want
    # 87 MB of weights and head at 3.35 TB/s: 26-29 µs, as PERF.md's bound
    assert 26e-6 < counts.bound_s(got["bytes"], got["flops"]) < 29e-6


def test_greedy_caption_flops(d):
    per_token = 2 * (NL * (6 * E * E + 2 * E * F) + V * E)
    got = counts.greedy_row_flops(d, 12, 29)
    assert 29 * per_token < got < 29 * per_token * 1.15  # about 2.8 GFLOP a caption
