"""The plain reference against the port on the CPU at a toy size, and runs
of each driver at that size with the timed path broken underneath: each
fault a cell can have has to turn ``correct`` false.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from tiny import tiny_cell

import run  # noqa: E402
from benchlib import data  # noqa: E402
from benchlib.weights import dims_of, float32, make_weights  # noqa: E402
from reference import checks as ref_checks  # noqa: E402
from reference import model as ref  # noqa: E402

SEED = 2 ** 31 + 977  # past 32 signed bits, as the driver's are


def port_model(cell, dims, dtype=torch.float32):
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.convert import load_state_dict_into
    from vct_tpu_torch.models.mmt4caption import MMT4Caption

    cfg = Config.from_dict(cell.config)
    model = MMT4Caption(dataclasses.replace(cfg.model, vocab_size=dims["vocab"]), cfg.tpu,
                        dtype=dtype)
    report = load_state_dict_into(model, make_weights(dims, SEED, "cpu"))
    assert report["unexpected"] == [] and all(k.endswith("pos_embedding")
                                              for k in report["missing"])
    return model


def inputs(dims, n=6, frames=(5, 20)):
    feats = [data.video_features(SEED, 3, i, frames, dims["feat_dim"]) for i in range(n)]
    x, pad = ref_checks.fitted(feats, dims["max_frames"], "cpu")
    caps = data.video_captions(SEED, 3, 0, n, (3, 30), dims["vocab"])
    ids = np.zeros((n, dims["max_caption_len"]), dtype=np.int64)
    for r, c in enumerate(caps):
        c = data.caption_ids(c, dims["max_caption_len"])
        ids[r, :len(c)] = c
    return feats, x, pad, torch.as_tensor(ids)


@pytest.fixture(scope="module")
def cell():
    return tiny_cell("msvd-train")


@pytest.fixture(scope="module")
def dims(cell):
    return dims_of(cell.config)


def test_reference_logits_match_the_port(cell, dims):
    model = port_model(cell, dims).eval()
    _, x, pad, ids = inputs(dims)
    with torch.no_grad():
        got, _, _ = model.caption_logits([x], [pad], ids, ids == 0)
        W, p = float32(make_weights(dims, SEED, "cpu")), ref.Precision()
        memory, mem_pad = ref.encode(W, dims, x, pad, p)
        want = ref.logits_of(W, ref.decode_hidden(W, dims, memory, mem_pad, ids[:, :-1], p,
                                                  key_pad=(ids == 0)[:, :-1]), p)
    assert (got - want).abs().max() < 1e-4


def test_reference_training_step_matches_the_port_dropout_included(cell, dims):
    """Loss and gradients of one training forward with dropout 0.3: the
    reference draws its masks from its own generator, seeded as the
    program's, in the order its forward pass meets them."""
    model = port_model(cell, dims).train()
    model.set_dropout_generator(torch.Generator().manual_seed(31))
    _, x, pad, ids = inputs(dims)
    ce, ce_n, rce, rce_n = model.caption_loss_parts([x], [pad], ids, ids == 0)
    alpha = dims["sce_alpha"]
    got = alpha * ce / ce_n + (1 - alpha) * rce / rce_n
    got.backward()
    W = {k: v.requires_grad_(True) for k, v in float32(make_weights(dims, SEED, "cpu")).items()}
    drop = ref.Dropout(0.3, torch.Generator().manual_seed(31))
    want = ref.caption_loss(W, dims, x, pad, ids, ref.Precision(), drop)
    want.backward()
    assert abs(float(got) - float(want)) < 1e-5
    for name, p in model.named_parameters():
        if p.grad is not None:
            g = W[name].grad
            assert (p.grad - g).abs().max() <= 1e-4 * max(1.0, float(g.abs().max())), name


def test_reference_beam_search_matches_the_port(cell, dims):
    from vct_tpu_torch.decode import make_auto_beam_fn

    model = port_model(cell, dims).eval()
    _, x, pad, _ = inputs(dims)
    tokens, scores = make_auto_beam_fn(model, dims["max_length"], data.START_ID, data.END_ID,
                                       4)([x], [pad])
    W, p = float32(make_weights(dims, SEED, "cpu")), ref.Precision()
    memory, mem_pad = ref.encode(W, dims, x, pad, p)
    want_t, want_s = ref.beam_search(W, dims, memory, mem_pad, beam=4,
                                     max_len=dims["max_length"], start_id=data.START_ID,
                                     end_id=data.END_ID, length_penalty=0.6, prec=p)
    assert torch.equal(tokens.long(), want_t)
    assert (scores.float() - want_s).abs().max() < 1e-4
    again = ref.hypothesis_scores(W, dims, memory, mem_pad, want_t, end_id=data.END_ID,
                                  length_penalty=0.6, prec=p)
    assert (again - want_s).abs().max() < 1e-4


def test_reference_greedy_gap_is_rounding_on_the_ports_float32_tokens(cell, dims):
    from vct_tpu_torch.decode import make_auto_greedy_fn

    model = port_model(cell, dims).eval()
    feats, x, pad, _ = inputs(dims)
    tokens, _ = make_auto_greedy_fn(model, dims["max_length"], data.START_ID,
                                    data.END_ID)([x], [pad])
    gap = ref_checks.greedy_gap(dims, SEED, feats, list(tokens.numpy()), "cpu")
    assert gap < 1e-4
    assert ref_checks.greedy_gap(dims, SEED, feats, list(tokens.numpy()), "cpu", "fp8") > gap


def drive(name, monkeypatch=None):
    cell = tiny_cell(name)
    _, out, result = run.run_cell(cell, seed=SEED, seconds=1.0, trace=False,
                                  device=torch.device("cpu"), t_process=time.perf_counter())
    return out, result


def failing(result):
    return sorted(k for k, c in result["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("name", ["msvd-serve", "msvd-train", "msvd-eval-beam4"])
def test_a_sound_run_is_correct(name):
    torch.set_num_threads(4)
    _, result = drive(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _alter_token(fn_name, monkeypatch):
    """The decode factory ``fn_name`` with one token of every row altered
    where it is produced."""
    import vct_tpu_torch.decode as dec

    real = getattr(dec, fn_name)

    def factory(*a, **k):
        inner = real(*a, **k)

        def call(feats, masks):
            tokens, other = inner(feats, masks)
            tokens = tokens.clone()
            tokens[:, 2] = (tokens[:, 2] + 7) % 400 + 104
            return tokens, other

        return call

    monkeypatch.setattr(dec, fn_name, factory)


def test_serve_token_altered_is_caught(monkeypatch):
    _alter_token("make_auto_greedy_fn", monkeypatch)
    _, result = drive("msvd-serve")
    assert not result["correct"] and "served_logit_gap" in failing(result)


def test_serve_answer_altered_is_caught(monkeypatch):
    import vct_tpu_torch.decode as dec

    real = dec.detokenize_batch
    monkeypatch.setattr(dec, "detokenize_batch",
                        lambda tok, tokens: [c + " w200" for c in real(tok, tokens)])
    _, result = drive("msvd-serve")
    assert not result["correct"] and "caption_mismatches" in failing(result)


def test_eval_token_altered_is_caught(monkeypatch):
    _alter_token("make_auto_beam_fn", monkeypatch)
    _, result = drive("msvd-eval-beam4")
    assert not result["correct"] and "beam_score_gap" in failing(result)


def test_train_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    import vct_tpu_torch.train.loop as loop
    from vct_tpu_torch.parallel.mesh import Mesh
    from vct_tpu_torch.train.step import task_loss

    def make(task, mesh=None):
        def step(state, batch):
            with torch.no_grad():
                _, metrics = task_loss(state.model, task, batch, Mesh())
            return state, metrics

        return step

    monkeypatch.setattr(loop, "make_train_step", make)
    _, result = drive("msvd-train")
    assert not result["correct"] and "change_gap" in failing(result)


def test_train_half_the_batch_left_out_is_caught(monkeypatch):
    import vct_tpu_torch.train.loop as loop

    real = loop.batch_to_arrays

    def half(batch, device, text_encoder=None):
        out = real(batch, device, text_encoder)
        valid = out["row_valid"].clone()
        valid[valid.shape[0] // 2:] = False
        return {**out, "row_valid": valid}

    monkeypatch.setattr(loop, "batch_to_arrays", half)
    _, result = drive("msvd-train")
    assert not result["correct"] and {"loss_gap", "grad_gap"} & set(failing(result))


def test_beam_rank_gap_catches_a_topk_that_keeps_the_wrong_candidates(cell, dims, monkeypatch):
    """A search whose top-k merge loses half of the vocabulary (it keeps the
    best candidates among the upper half's ids), its captions scored right:
    the score gap stays at rounding, the rank gap does not."""
    _, x, pad, _ = inputs(dims)
    W, p = float32(make_weights(dims, SEED, "cpu")), ref.Precision()
    memory, mem_pad = ref.encode(W, dims, x, pad, p)
    real = ref.topk_first_win
    vocab = dims["vocab"]

    def half_merge(v, k):
        ids = torch.arange(v.shape[1]) % vocab
        return real(v.masked_fill(ids < vocab // 2, ref.NEG_INF), k)

    monkeypatch.setattr(ref, "topk_first_win", half_merge)
    tokens, _ = ref.beam_search(W, dims, memory, mem_pad, beam=4, max_len=dims["max_length"],
                                start_id=data.START_ID, end_id=data.END_ID,
                                length_penalty=0.6, prec=p)
    monkeypatch.setattr(ref, "topk_first_win", real)
    scores = ref.hypothesis_scores(W, dims, memory, mem_pad, tokens, end_id=data.END_ID,
                                   length_penalty=0.6, prec=p)
    feats = [data.video_features(SEED, 3, i, (5, 20), dims["feat_dim"]) for i in range(6)]
    got = ref_checks.beam_gaps(dims, SEED, feats, list(tokens.numpy()), list(scores.numpy()),
                               "cpu", beam=4, length_penalty=0.6)
    assert got["beam_score_gap"] < 1e-4
    assert got["beam_rank_gap"] > 0.01
