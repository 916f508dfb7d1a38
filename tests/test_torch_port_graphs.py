"""The port's compiled decode programs on the CPU, in float32:
``decode_fast.make_fused_greedy_fn`` / ``make_fused_beam_fn`` against the
reference's factories (``vct_tpu.decode_fast``, Pallas interpret mode), the
staged loop over static buffers against the eager loop
(``greedy_generate_fused`` / ``beam_generate_fused``) bit for bit, the
runner's keying and results, and the encoder's device tables.

On the CPU no CUDA graph is built: the stage functions that a card captures
run directly, on the kernels' plain versions. Greedy tokens against the
reference are equal except where a row's first difference falls on a
near-tie (a top-2 logit gap below ``NEAR_TIE`` = 1e-4, as in
``test_torch_port_decode.py``); beam tokens equal and scores within 1e-4, as
in ``test_torch_port_beam.py``. Card tests: ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vct_tpu.decode_fast import make_fused_beam_fn as jax_make_fused_beam_fn
from vct_tpu.decode_fast import make_fused_greedy_fn as jax_make_fused_greedy_fn
from vct_tpu_torch.decode import first_mismatch_gaps, make_auto_beam_fn, make_auto_greedy_fn
from vct_tpu_torch.decode_fast import (
    beam_generate_fused,
    greedy_generate_fused,
    make_fused_beam_fn,
    make_fused_greedy_fn,
)
from vct_tpu_torch.graphs import stage_bounds

from tests.test_torch_port_modules import D_FEAT, T, build_pair

NEAR_TIE = 1e-4
MAX_LEN = 10
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair3():
    return build_pair(dec_layers=3)


def inputs(b, seed=0, t=T):
    """Features [b, t, D_FEAT] and pad masks (every third row ends in 2 pads)."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((b, t, D_FEAT)).astype(np.float32)]
    pad = np.zeros((b, t), bool)
    pad[1::3, -2:] = True
    return feats, [pad]


def torch_of(arrays):
    return [torch.tensor(a) for a in arrays]


def jax_of(arrays):
    return [jnp.asarray(a) for a in arrays]


def assert_same_tokens(pm, feats, masks, got, want):
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    for row, pos, gap in first_mismatch_gaps(pm, torch_of(feats), torch_of(masks), got, want):
        assert gap < NEAR_TIE, (row, pos, gap, got[row], want[row])


def test_stage_bounds_are_the_loops_8_token_stages():
    assert stage_bounds(30) == [(0, 8, 8), (8, 16, 16), (16, 24, 24), (24, 29, 32)]
    assert stage_bounds(10) == [(0, 8, 8), (8, 9, 16)]
    assert stage_bounds(9) == [(0, 8, 8)]
    assert stage_bounds(1) == []


@pytest.mark.parametrize("b,single_kernel", [(4, True), (72, False)])
def test_fused_greedy_fn_matches_reference_factory(pair3, b, single_kernel):
    """The whole-step route at <= 64 rows, the stack + argmax route above,
    with row 0 ending early: the reference's ``make_fused_greedy_fn`` picks
    its route by the rows as the port does."""
    from vct_tpu_torch.decode_fast import _resolve_tiling

    assert _resolve_tiling(b, None) is single_kernel
    jm, variables, pm = pair3
    feats, masks = inputs(b)
    first = jax_make_fused_greedy_fn(jm, MAX_LEN, 2, -1, interpret=True)
    free, _ = first(variables, jax_of(feats), jax_of(masks))
    end_id = int(np.asarray(free)[0, 3])
    want, _ = jax_make_fused_greedy_fn(jm, MAX_LEN, 2, end_id, interpret=True)(
        variables, jax_of(feats), jax_of(masks))
    got, attn = make_fused_greedy_fn(pm, MAX_LEN, 2, end_id)(torch_of(feats), torch_of(masks))
    assert attn is None and got.dtype == torch.int32 and got.shape == (b, MAX_LEN)
    assert (got[0] == end_id).any()
    assert_same_tokens(pm, feats, masks, got, want)


@pytest.mark.parametrize("early", [False, True])
def test_fused_beam_fn_matches_reference_factory(pair3, early):
    jm, variables, pm = pair3
    b, k = 4, 3
    feats, masks = inputs(b, seed=1)
    end_id = -1
    if early:
        free, _ = jax_make_fused_beam_fn(jm, MAX_LEN, 2, -1, k, block_b=b * k,
                                         interpret=True)(variables, jax_of(feats),
                                                         jax_of(masks))
        end_id = int(np.asarray(free)[0, 3])
    tok_j, sc_j = jax_make_fused_beam_fn(jm, MAX_LEN, 2, end_id, k, block_b=b * k,
                                         interpret=True)(variables, jax_of(feats),
                                                         jax_of(masks))
    tok_t, sc_t = make_fused_beam_fn(pm, MAX_LEN, 2, end_id, k)(torch_of(feats),
                                                                torch_of(masks))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), **TOL)
    if early:
        assert (tok_t == end_id).any()


@pytest.mark.parametrize("b", [4, 72])
@pytest.mark.parametrize("early", [False, True])
def test_staged_greedy_is_the_eager_loop_bit_for_bit(pair3, b, early):
    """The static-buffer stages give ``greedy_generate_fused``'s tokens bit for
    bit on both routes, with no row finishing and with row 0 finishing early,
    on a set's first call and on a later one."""
    _, _, pm = pair3
    feats, masks = (torch_of(a) for a in inputs(b, seed=2))
    kw = dict(max_len=MAX_LEN, start_id=2)
    free, _ = greedy_generate_fused(pm, feats, masks, end_id=-1, **kw)
    end_id = int(free[0, 3]) if early else -1
    want, _ = greedy_generate_fused(pm, feats, masks, end_id=end_id, **kw)
    fn = make_fused_greedy_fn(pm, MAX_LEN, 2, end_id)
    for _ in range(2):
        got, _ = fn(feats, masks)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fn.sets == 1


def test_staged_greedy_early_exit_pads_the_rest():
    """A generator biased to emit token 5: with end_id 5 every row finishes at
    step 1, the host skips the second stage and the rest stays [PAD], as in
    the eager loop."""
    _, _, pm = build_pair()
    with torch.no_grad():
        pm.cap_decoder.generator.bias[5] = 1e3
    feats, masks = (torch_of(a) for a in inputs(4))
    got, _ = make_fused_greedy_fn(pm, MAX_LEN, 2, 5)(feats, masks)
    assert got.tolist() == [[2, 5] + [0] * (MAX_LEN - 2)] * 4
    want, _ = greedy_generate_fused(pm, feats, masks, max_len=MAX_LEN, start_id=2, end_id=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("early", [False, True])
def test_staged_beam_is_the_eager_loop_bit_for_bit(pair3, early):
    _, _, pm = pair3
    feats, masks = (torch_of(a) for a in inputs(5, seed=3))
    kw = dict(beam_size=3, max_len=MAX_LEN, start_id=2)
    free, _ = beam_generate_fused(pm, feats, masks, end_id=-1, **kw)
    end_id = int(free[0, 2]) if early else -1
    want_t, want_s = beam_generate_fused(pm, feats, masks, end_id=end_id, **kw)
    fn = make_fused_beam_fn(pm, MAX_LEN, 2, end_id, 3)
    for _ in range(2):
        got_t, got_s = fn(feats, masks)
        torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)
        torch.testing.assert_close(got_s, want_s, rtol=0, atol=0)


def test_one_set_per_shape(pair3):
    """The runner's counter: one set for each new shape (rows, frames,
    dtype), none for a shape it has; on the CPU no graph is captured."""
    _, _, pm = pair3
    fn = make_fused_greedy_fn(pm, MAX_LEN, 2, -1)
    calls = [(4, T, 0), (4, T, 1), (2, T, 2), (4, T, 3), (4, T + 3, 4), (2, T, 5)]
    want_sets = [1, 1, 2, 2, 3, 3]
    for (b, t, seed), sets in zip(calls, want_sets):
        feats, masks = inputs(b, seed, t)
        got, _ = fn(torch_of(feats), torch_of(masks))
        want, _ = greedy_generate_fused(pm, torch_of(feats), torch_of(masks),
                                        max_len=MAX_LEN, start_id=2, end_id=-1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert fn.sets == sets, (b, t, fn.sets)
    fn(torch_of(inputs(4)[0]), None)  # no masks: another shape key
    assert (fn.sets, fn.graphs, fn.replays) == (4, 0, 0)


def test_auto_dispatch_exposes_its_runner(pair3):
    _, _, pm = pair3
    feats, masks = inputs(4)
    greedy = make_auto_greedy_fn(pm, MAX_LEN, 2, -1)
    beam = make_auto_beam_fn(pm, MAX_LEN, 2, -1, 2)
    for fn in (greedy, beam):
        for _ in range(2):
            fn(torch_of(feats), torch_of(masks))
        assert fn.runner.sets == 1
    # the module path (attention maps) is staged too, and names its runner
    attn = make_auto_greedy_fn(pm, MAX_LEN, 2, -1, collect_attn=True)
    attn(torch_of(feats), torch_of(masks))
    assert attn.runner.sets == 1


@pytest.mark.parametrize("factory", ["greedy", "beam"])
def test_results_do_not_alias_across_calls(pair3, factory):
    """Two results held at once: the first is not overwritten by the second
    call into the same set, and no result shares memory with the set's
    state, which a card's replays write in place on every call (on the CPU
    each call makes its state anew, so the storage check is what sees a
    result handed out without its copy)."""
    _, _, pm = pair3
    fn = (make_fused_greedy_fn(pm, MAX_LEN, 2, -1) if factory == "greedy"
          else make_fused_beam_fn(pm, MAX_LEN, 2, -1, 2))
    first, _ = fn(*[torch_of(a) for a in inputs(4, seed=4)])
    kept = first.clone()
    second, _ = fn(*[torch_of(a) for a in inputs(4, seed=5)])
    torch.testing.assert_close(first, kept, rtol=0, atol=0)
    assert not torch.equal(first, second)
    (gs,) = fn._sets.values()
    state = {t.untyped_storage().data_ptr() for t in gs.st.values()
             if isinstance(t, torch.Tensor)}
    assert second.untyped_storage().data_ptr() not in state


def _encoder_model(enc_type, temporal, modal_shape, layer=1):
    from vct_tpu_torch.config import ModelConfig, TPUConfig
    from vct_tpu_torch.models.mmt4caption import MMT4Caption

    cfg = ModelConfig.from_dict({
        "modal": [f"m{i}" for i in range(len(modal_shape))],
        "modal_shape": list(modal_shape), "embed_dim": 32, "dropout": 0.0,
        "vocab_size": 40,
        "video_encoder": {"type": enc_type, "layer": layer, "nhead": 4, "feedforward": 64,
                          "mme": {"temporal": temporal, "aggregation": "avg"}},
        "caption_decoder": {"layer": 1, "nhead": 4, "feedforward": 64},
    })
    model = MMT4Caption(cfg, TPUConfig(dtype="float32"))
    model.init_weights(torch.Generator().manual_seed(0))
    return model.eval()


@pytest.mark.parametrize("enc_type,temporal,layer", [("mme", "encoding", 1),
                                                     ("mme", "embedding", 1),
                                                     ("hmme", "encoding", [2, 1]),
                                                     ("simple", "encoding", 1)])
def test_encoder_tables_are_made_once_per_shape(monkeypatch, enc_type, temporal, layer):
    """The encoder's temporal and modality tables equal the numpy ones, and a
    second encode of a shape copies nothing from numpy to the device (counted
    through ``torch.as_tensor``), which a CUDA graph's capture forbids."""
    from vct_tpu_torch.models.embeddings import temporal_embedding_indices, temporal_encoding

    model = _encoder_model(enc_type, temporal, (12, 8), layer)
    rng = np.random.default_rng(6)
    feats = [torch.tensor(rng.standard_normal((2, t, d)).astype(np.float32))
             for t, d in ((9, 12), (5, 8))]
    masks = [torch.zeros((2, 9), dtype=torch.bool), torch.zeros((2, 5), dtype=torch.bool)]
    with torch.no_grad():
        want = model.encode(feats, masks)[0]
    copies = []
    as_tensor = torch.as_tensor

    def counting(*a, **k):
        copies.append(a[0])
        return as_tensor(*a, **k)

    monkeypatch.setattr(torch, "as_tensor", counting)
    with torch.no_grad():
        again = model.encode(feats, masks)[0]
    assert copies == []
    torch.testing.assert_close(again, want, rtol=0, atol=0)
    enc = model.video_encoder
    if enc_type == "simple":
        tables = list(enc._tables.values())
        for got, table in zip(tables, temporal_encoding([9, 5], 32, separate=True)):
            np.testing.assert_array_equal(got.numpy(), table)
        assert len(tables) == 2
        return
    lengths = [10, 6]  # each modality's frames and its global token
    if temporal == "encoding":
        (table,) = enc._tables.values()
        np.testing.assert_array_equal(table.numpy(), temporal_encoding(lengths, 32))
    else:
        (idx,) = enc.temp_emb._indices.values()
        np.testing.assert_array_equal(idx.numpy(), temporal_embedding_indices(lengths))
    (labels,) = enc.modal_emb._labels.values()
    assert labels.tolist() == enc.modal_emb.labels(lengths)
