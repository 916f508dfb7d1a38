"""Beam search of the port against ``vct_tpu``, in float32 on the CPU: the
top-k kernel's plain version and ``fused_layer_step``'s against the Pallas
kernels in interpret mode, ``beam_generate`` (module path) and
``beam_generate_fused`` (kernel path, plain versions on CPU tensors) against
their JAX counterparts, and the entry points that take ``tpu.beam_size``.

Tolerances: top-k values, logsumexp, one layer's step and beam scores agree
to 1e-5 (two frameworks summing a few hundred float32 terms in different
orders); ids and tokens must be equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.decode import beam_generate as jax_beam
from vct_tpu.decode_fast import beam_generate_fused as jax_beam_fused
from vct_tpu.ops import pallas_decode as ref
from vct_tpu_torch.config import Config
from vct_tpu_torch.decode import (
    beam_generate,
    greedy_generate,
    make_auto_beam_fn,
    make_beam_fn,
)
from vct_tpu_torch.decode_fast import (
    beam_generate_fused,
    fused_beam_supported,
    greedy_generate_fused,
)
from vct_tpu_torch.ops import decode_kernels as dk

from tests.test_torch_port_kernels import B as KB
from tests.test_torch_port_kernels import BLOCK_V, H, V, _f32, _inputs
from tests.test_torch_port_modules import B, build_pair, make_inputs, to_jax, to_torch
from tests.test_torch_port_train import config_dict, workspace  # noqa: F401  (fixture)

MAX_LEN = 10
TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 8])
def test_topk_reference_matches_jax_kernel(k):
    _, _, ta, ja = _inputs(21, 0, "float32")
    v_j, i_j, lse_j = ref.fused_norm_generator_topk(
        ja["x"], ja["norm_s"], ja["norm_b"], ja["wg"], ja["bg"], k=k, block_b=KB,
        block_v=BLOCK_V, interpret=True)
    v_t, i_t, lse_t = dk.fused_norm_generator_topk(
        ta["x"], ta["norm_s"], ta["norm_b"], ta["wg"], ta["bg"], k=k)
    assert i_t.dtype == torch.int32 and i_t.shape == (KB, k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)
    assert int(i_t.max()) < V  # padded vocab columns are never selected


def test_topk_tie_across_tiles_goes_to_the_lowest_id():
    """Weight columns tied pairwise across two vocab tiles (column j equals
    column j + 128): both implementations list the lower id first."""
    rng = np.random.default_rng(5)
    b, e, bv, k = 4, 128, 128, 3
    x = rng.standard_normal((b, e)).astype(np.float32)
    half = rng.standard_normal((e, bv)).astype(np.float32)
    wg = np.concatenate([half, half], axis=1)
    ns, nb, bg = np.ones(e, np.float32), np.zeros(e, np.float32), np.zeros(2 * bv, np.float32)
    v_j, i_j, _ = ref.fused_norm_generator_topk(
        *(jnp.asarray(a) for a in (x, ns, nb, wg, bg)), k=k, block_b=4, block_v=bv,
        interpret=True)
    v_t, i_t, _ = dk.fused_norm_generator_topk(
        *(torch.tensor(a) for a in (x, ns, nb, wg, bg)), k=k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    # the pair (j, j + 128) shares its logit: j comes first, then j + 128
    assert (i_t[:, 1] == i_t[:, 0] + bv).all() and (i_t[:, 0] < bv).all()


def test_topk_refuses_a_beam_wider_than_the_kernel_carries():
    """The plain version (CPU tensors) takes any k up to the vocab width; the
    kernel's own cap raises on a card (``tests/test_torch_port_cuda.py``)."""
    _, _, ta, _ = _inputs(22, 0, "float32")
    args = (ta["x"], ta["norm_s"], ta["norm_b"], ta["wg"], ta["bg"])
    for k in (0, ta["wg"].shape[1] + 1):
        with pytest.raises(ValueError, match="outside"):
            dk.fused_norm_generator_topk(*args, k=k)
    assert dk.TOPK_MAX >= 8
    v_t, i_t, _ = dk.fused_norm_generator_topk(*args, k=dk.TOPK_MAX + 1)
    assert i_t.shape == (KB, dk.TOPK_MAX + 1) and (v_t[:, :-1] >= v_t[:, 1:]).all()
    with pytest.raises(RuntimeError, match="no kernel"):
        dk.fused_norm_generator_topk(*(a.to("meta") for a in args), k=2)


def test_topk_first_win_takes_the_lowest_index_like_lax_top_k():
    vals = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0], [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]],
                    np.float32)
    v_j, i_j = jax.lax.top_k(jnp.asarray(vals), 4)
    v_t, i_t = dk.topk_first_win(torch.tensor(vals), 4)
    assert i_t.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]] == np.asarray(i_j).tolist()
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("idx,with_bias", [(0, True), (5, True), (11, False)])
def test_layer_step_reference_matches_jax_kernel(idx, with_bias):
    tw, jw, ta, ja = _inputs(30 + idx, idx, "float32")
    tw1 = {k: v[1].contiguous() for k, v in tw.items()}  # layer 1's un-stacked set
    jw1 = {k: v[1] for k, v in jw.items()}
    x_j, k_j, v_j = ref.fused_layer_step(
        ja["x"], ja["kc"][1], ja["vc"][1], ja["ck"][1], ja["cv"][1],
        ja["mem_bias"] if with_bias else None, jw1, idx, heads=H, block_b=KB,
        interpret=True)
    before = dk.fused_layer_step.launches
    x_t, k_t, v_t = dk.fused_layer_step(
        ta["x"], ta["kc"][1].clone(), ta["vc"][1].clone(), ta["ck"][1], ta["cv"][1],
        ta["mem_bias"] if with_bias else None, tw1, idx, heads=H)
    assert dk.fused_layer_step.launches == before  # the plain version ran
    np.testing.assert_allclose(_f32(x_t), _f32(x_j), **TOL)
    np.testing.assert_allclose(_f32(k_t), _f32(k_j), **TOL)
    np.testing.assert_allclose(_f32(v_t), _f32(v_j), **TOL)


def test_layer_step_is_one_layer_of_the_stack():
    """Layer by layer through ``fused_layer_step`` equals ``fused_layers_step``."""
    tw, _, ta, _ = _inputs(40, 6, "float32")
    kc, vc = ta["kc"].clone(), ta["vc"].clone()
    x_stack, _, _ = dk.fused_layers_step(ta["x"], kc, vc, ta["ck"], ta["cv"],
                                         ta["mem_bias"], tw, 6, heads=H)
    x = ta["x"]
    for li in range(tw["wqkv"].shape[0]):
        x, k_li, _ = dk.fused_layer_step(
            x, ta["kc"][li].clone(), ta["vc"][li].clone(), ta["ck"][li], ta["cv"][li],
            ta["mem_bias"], {k: v[li] for k, v in tw.items()}, 6, heads=H)
        torch.testing.assert_close(k_li, kc[li], rtol=0, atol=0)
    torch.testing.assert_close(x, x_stack, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# beam search, both paths, against vct_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair3():
    return build_pair(dec_layers=3)


def _early_end_id(jm, variables, feats, masks, k):
    """A token that the best beam of row 0 emits at position 3: as ``end_id``
    it finishes beams early."""
    tokens, _ = jax_beam(jm, variables, to_jax(feats), to_jax(masks), beam_size=k,
                         max_len=MAX_LEN, start_id=2, end_id=-1)
    return int(np.asarray(tokens)[0, 3])


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("k", [3])
def test_beam_module_path_matches_reference(pair3, k, early):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    end_id = _early_end_id(jm, variables, feats, masks, k) if early else -1
    tok_j, sc_j = jax_beam(jm, variables, to_jax(feats), to_jax(masks), beam_size=k,
                           max_len=MAX_LEN, start_id=2, end_id=end_id)
    tok_t, sc_t = beam_generate(pm, to_torch(feats), to_torch(masks), beam_size=k,
                                max_len=MAX_LEN, start_id=2, end_id=end_id)
    assert tok_t.dtype == torch.int32 and tok_t.shape == (B, MAX_LEN)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), **TOL)
    if early:
        assert (tok_t == end_id).any()


@pytest.mark.parametrize("early", [False, True])
def test_beam_kernel_path_matches_reference_fused_beam(pair3, early):
    jm, variables, pm = pair3
    feats, masks = make_inputs()
    k = 3
    end_id = _early_end_id(jm, variables, feats, masks, k) if early else -1
    tok_j, sc_j = jax_beam_fused(jm, variables, to_jax(feats), to_jax(masks), beam_size=k,
                                 max_len=MAX_LEN, start_id=2, end_id=end_id, block_b=B * k,
                                 block_v=128, interpret=True)
    tok_t, sc_t = beam_generate_fused(pm, to_torch(feats), to_torch(masks), beam_size=k,
                                      max_len=MAX_LEN, start_id=2, end_id=end_id)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), **TOL)
    # and the port's two paths agree with each other
    tok_m, sc_m = beam_generate(pm, to_torch(feats), to_torch(masks), beam_size=k,
                                max_len=MAX_LEN, start_id=2, end_id=end_id)
    np.testing.assert_array_equal(tok_t.numpy(), tok_m.numpy())
    np.testing.assert_allclose(sc_t.numpy(), sc_m.numpy(), **TOL)


@pytest.mark.parametrize("fn,greedy", [(beam_generate, greedy_generate),
                                       (beam_generate_fused, greedy_generate_fused)])
def test_beam_one_equals_greedy(pair3, fn, greedy):
    _, _, pm = pair3
    feats, masks = make_inputs(seed=4)
    want, _ = greedy(pm, to_torch(feats), to_torch(masks), max_len=MAX_LEN, start_id=2,
                     end_id=-1)
    got, _ = fn(pm, to_torch(feats), to_torch(masks), beam_size=1, max_len=MAX_LEN,
                start_id=2, end_id=-1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_frozen_beams_make_the_staged_early_exit_exact():
    """Every beam finishes at step 1 (a generator biased to the end token):
    the port goes on to the end of its 8-step stage and still returns what
    the reference returns after leaving at once, for both paths."""
    jm, variables, pm = build_pair()
    with torch.no_grad():
        pm.cap_decoder.generator.bias[5] = 1e3
    variables["params"]["cap_decoder"]["generator"]["bias"][5] = 1e3
    feats, masks = make_inputs()
    tok_j, sc_j = jax_beam(jm, variables, to_jax(feats), to_jax(masks), beam_size=3,
                           max_len=MAX_LEN, start_id=2, end_id=5)
    assert np.asarray(tok_j).tolist() == [[2, 5] + [0] * (MAX_LEN - 2)] * B
    for fn in (beam_generate, beam_generate_fused):
        tok_t, sc_t = fn(pm, to_torch(feats), to_torch(masks), beam_size=3,
                         max_len=MAX_LEN, start_id=2, end_id=5)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), **TOL)


def test_candidate_ties_resolve_to_the_lowest_flat_index():
    """Two vocab columns with identical generator weights tie in every beam
    at every step: both packages must break each tie the same way, on both
    paths (over K*V on the module path, over K*K on the kernel path)."""
    jm, variables, pm = build_pair()
    gen = variables["params"]["cap_decoder"]["generator"]
    gen["kernel"][:, 40] = gen["kernel"][:, 7]
    gen["bias"][40] = gen["bias"][7] = 4.0  # the tied pair leads the vocab
    with torch.no_grad():
        w, b = pm.cap_decoder.generator.weight, pm.cap_decoder.generator.bias
        w[40] = w[7]
        b[40] = b[7] = 4.0
    feats, masks = make_inputs(seed=2)
    tok_j, sc_j = jax_beam(jm, variables, to_jax(feats), to_jax(masks), beam_size=4,
                           max_len=MAX_LEN, start_id=2, end_id=-1)
    assert np.isin(np.asarray(tok_j)[:, 1:], (7, 40)).any()
    for fn in (beam_generate, beam_generate_fused):
        tok_t, sc_t = fn(pm, to_torch(feats), to_torch(masks), beam_size=4,
                         max_len=MAX_LEN, start_id=2, end_id=-1)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), **TOL)


def test_auto_beam_dispatch(pair3):
    """``make_auto_beam_fn`` always takes the kernel path. On CPU tensors that
    is the plain versions at any beam width; on a card a beam wider than the
    top-k kernel carries raises (``tests/test_torch_port_cuda.py``) and
    nothing falls to the module path."""
    _, _, pm = pair3
    feats, masks = make_inputs()
    assert fused_beam_supported(4) and fused_beam_supported(dk.TOPK_MAX)
    assert not fused_beam_supported(dk.TOPK_MAX + 1) and not fused_beam_supported(0)
    auto = make_auto_beam_fn(pm, MAX_LEN, 2, -1, 3)
    tok_a, sc_a = auto(to_torch(feats), to_torch(masks))
    tok_m, sc_m = make_beam_fn(pm, MAX_LEN, 2, -1, 3)(to_torch(feats), to_torch(masks))
    np.testing.assert_array_equal(tok_a.numpy(), tok_m.numpy())
    np.testing.assert_allclose(sc_a.numpy(), sc_m.numpy(), **TOL)
    wide = dk.TOPK_MAX + 1
    tok_w, sc_w = make_auto_beam_fn(pm, 6, 2, -1, wide)(to_torch(feats), to_torch(masks))
    tok_m, sc_m = make_beam_fn(pm, 6, 2, -1, wide)(to_torch(feats), to_torch(masks))
    np.testing.assert_array_equal(tok_w.numpy(), tok_m.numpy())
    np.testing.assert_allclose(sc_w.numpy(), sc_m.numpy(), **TOL)


def test_auto_beam_never_takes_the_module_path(pair3, monkeypatch):
    import vct_tpu_torch.decode as dec

    def refuse(*a, **k):
        raise AssertionError("the module path ran behind make_auto_beam_fn")

    monkeypatch.setattr(dec, "beam_generate", refuse)
    _, _, pm = pair3
    feats, masks = make_inputs()
    for k in (2, dk.TOPK_MAX + 1):
        tokens, _ = make_auto_beam_fn(pm, 6, 2, -1, k)(to_torch(feats), to_torch(masks))
        assert tokens.shape == (B, 6)


# ---------------------------------------------------------------------------
# the entry points that take tpu.beam_size
# ---------------------------------------------------------------------------


def test_trainer_decodes_with_beam_search(workspace):  # noqa: F811
    from vct_tpu_torch.train.loop import Trainer

    cfg = config_dict(workspace, epochs=1, tag="beam", save_dir="ckpt_beam")
    cfg["tpu"]["beam_size"] = 2
    trainer = Trainer(Config.from_dict(cfg), device=torch.device("cpu"),
                      log=lambda *_: None)
    beam = trainer.decode_split(trainer.loaders["eval"])
    scores = trainer.eval_epoch()
    assert set(beam) == set(trainer.datasets["eval"].video2caption)
    assert {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(scores)
    # the same weights with beam_size 1 decode greedily: another decoder
    cfg["tpu"]["beam_size"] = 1
    greedy = Trainer(Config.from_dict(cfg), device=torch.device("cpu"),
                     log=lambda *_: None)
    assert set(greedy.decode_split(greedy.loaders["eval"])) == set(beam)


def test_server_serves_beam_search(workspace, tmp_path):  # noqa: F811
    from vct_tpu_torch.cli.common import make_trainer_pieces
    from vct_tpu_torch.serve import CaptionService
    from vct_tpu_torch.train.state import save_params_only

    cfg_d = config_dict(workspace)
    cfg_d["tpu"]["beam_size"] = 3
    cfg = Config.from_dict(json.loads(json.dumps(cfg_d)))
    model, tokenizer = make_trainer_pieces(cfg, torch.device("cpu"))
    ckpt = tmp_path / "w.pth"
    save_params_only(str(ckpt), model)
    service = CaptionService(cfg, str(ckpt), device=torch.device("cpu"), max_batch=2,
                             log=lambda *_: None)
    try:
        feats = np.load(workspace / "feats" / "vid0.npy")
        caption = service.caption_features(feats)
    finally:
        service.close()
    fn = make_beam_fn(model, cfg.test.max_length, tokenizer.start_id, tokenizer.end_id, 3)
    from vct_tpu_torch.data.collate import fit_time_axis

    f, m = fit_time_axis(feats, cfg.tpu.max_frames)
    tokens, _ = fn([torch.from_numpy(f[None])], [torch.from_numpy(m[None])])
    assert caption == tokenizer.decode_caption(tokens[0].numpy())
