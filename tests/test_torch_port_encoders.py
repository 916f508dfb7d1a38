"""The port's encoder families against the JAX reference, in float32 on the CPU:
HMME, SimpleSep, MME with the learned temporal embedding, and every global
aggregation (masked and with ``quirk_unmasked_aggregation``).

Both packages get the same weights (the JAX init carried across through
``vct_tpu_torch.convert.state_dict_from_jax``; missing and unexpected keys
must be empty) and the same numpy inputs. Tolerance 1e-5 on one encoder
(float32 summation order), 1e-4 relative on a loss through the decoder.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.config import ModelConfig, TPUConfig
from vct_tpu.decode import greedy_generate as jax_greedy
from vct_tpu.models.embeddings import GlobalAggregation as JaxAggregation
from vct_tpu.models.mmt4caption import MMT4Caption as JaxMMT4Caption
from vct_tpu_torch.convert import load_state_dict_into, state_dict_from_jax
from vct_tpu_torch.decode import first_mismatch_gaps, greedy_generate
from vct_tpu_torch.models.embeddings import (
    GlobalAggregation,
    temporal_embedding_indices,
    temporal_encoding,
)
from vct_tpu_torch.models.mmt4caption import MMT4Caption

B, T1, T2, D1, D2, E, H, FF, VOCAB, CAP = 3, 9, 5, 12, 8, 32, 4, 64, 60, 8
TOL = dict(atol=1e-5, rtol=1e-5)


def _config(enc_type, layer, **mme):
    return ModelConfig.from_dict({
        "modal": ["a", "b"], "modal_shape": [D1, D2], "embed_dim": E, "dropout": 0.0,
        "vocab_size": VOCAB,
        "video_encoder": {"type": enc_type, "layer": layer, "nhead": H, "feedforward": FF,
                          "mme": {"temporal": "encoding", "aggregation": "avg", **mme}},
        "caption_decoder": {"layer": 2, "nhead": H, "feedforward": FF},
    })


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, T1, D1)).astype(np.float32),
             rng.standard_normal((B, T2, D2)).astype(np.float32)]
    masks = [np.zeros((B, T1), bool), np.zeros((B, T2), bool)]
    masks[0][1, -3:] = True
    masks[1][2, -1:] = True
    caps = rng.integers(3, VOCAB, (B, CAP)).astype(np.int32)
    caps[:, 0] = 2
    caps[1, 5:] = 0
    return feats, masks, caps, caps == 0


def _pair(cfg, **tpu):
    tpu = TPUConfig(dtype="float32", **tpu)
    jm = JaxMMT4Caption(cfg, tpu)
    feats, masks, caps, cap_pad = _batch()
    variables = jm.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats],
                        [jnp.asarray(m) for m in masks], jnp.asarray(caps),
                        jnp.asarray(cap_pad), method=JaxMMT4Caption.caption_loss)
    variables = jax.tree_util.tree_map(np.array, variables)
    pm = MMT4Caption(cfg, tpu)
    report = load_state_dict_into(pm, state_dict_from_jax(variables))
    assert report == {"missing": [], "unexpected": []}, report
    return jm, variables, pm.eval()


def _encode_both(jm, variables, pm, seed=3):
    feats, masks, _, _ = _batch(seed)
    want = jm.apply(variables, [jnp.asarray(f) for f in feats],
                    [jnp.asarray(m) for m in masks], method=JaxMMT4Caption.encode)
    with torch.no_grad():
        got = pm.encode([torch.tensor(f) for f in feats], [torch.tensor(m) for m in masks])
    return got, want


ENCODERS = [
    pytest.param("hmme", [2, 1], {}, id="hmme-2-1"),
    pytest.param("hmme", [1, 3], {"aggregation": "max", "modal_different": False},
                 id="hmme-1-3-max"),
    pytest.param("hmme", [2, 2], {"temporal": "embedding", "do_norm": True},
                 id="hmme-2-2-embedding-norm"),
    pytest.param("simple", 1, {}, id="simple-1"),
    pytest.param("simple", 2, {}, id="simple-2"),
    pytest.param("mme", 1, {"temporal": "embedding"}, id="mme-embedding"),
    pytest.param("mme", 2, {"temporal": "embedding", "aggregation": "GRU"},
                 id="mme-embedding-gru"),
]


@pytest.mark.parametrize("enc_type,layer,mme", ENCODERS)
def test_encoder_family_matches_reference(enc_type, layer, mme):
    jm, variables, pm = _pair(_config(enc_type, layer, **mme))
    (mem_p, mask_p, agg_p), (mem_j, mask_j, agg_j) = _encode_both(jm, variables, pm)
    np.testing.assert_allclose(mem_p.numpy(), np.asarray(mem_j), **TOL)
    if enc_type == "simple":
        assert mem_p.shape == (B, T1 + T2, E)
        assert mask_p is None and agg_p is None and mask_j is None and agg_j is None
    else:
        assert mem_p.shape == (B, T1 + T2 + 2, E)
        np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
        np.testing.assert_allclose(agg_p.numpy(), np.asarray(agg_j), **TOL)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("method", ["max", "avg", "GRU", "biGRU"])
def test_mme_with_each_aggregation_matches_reference(method, quirk):
    jm, variables, pm = _pair(_config("mme", 1, aggregation=method),
                              quirk_unmasked_aggregation=quirk)
    (mem_p, _, agg_p), (mem_j, _, agg_j) = _encode_both(jm, variables, pm)
    np.testing.assert_allclose(mem_p.numpy(), np.asarray(mem_j), **TOL)
    np.testing.assert_allclose(agg_p.numpy(), np.asarray(agg_j), **TOL)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("method", ["max", "avg", "GRU", "biGRU"])
def test_global_aggregation_matches_reference(method, quirk):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T1, E)).astype(np.float32)
    pad = np.zeros((B, T1), bool)
    pad[0, -4:] = True
    jm = JaxAggregation(method, E, quirk_unmasked=quirk)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(pad))
    pm = GlobalAggregation(method, E, quirk)
    report = load_state_dict_into(pm, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    assert report == {"missing": [], "unexpected": []}, report
    with torch.no_grad():
        got = pm(torch.tensor(x), torch.tensor(pad))
    assert got.shape == (B, 1, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if method in ("max", "avg"):
        # padding changes the pooled value exactly when it is not masked out
        with torch.no_grad():
            shifted = (x + 5.0 * pad[..., None]).astype(np.float32)
            moved = pm(torch.tensor(shifted), torch.tensor(pad))
        assert bool(((moved[0] - got[0]).abs() > 1e-3).any()) is quirk


def test_gru_parameters_carry_the_reference_state_dict_names():
    pm = GlobalAggregation("biGRU", E)
    names = {n for n, _ in pm.named_parameters()}
    want = {f"agg.{w}_l0{suffix}" for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
            for suffix in ("", "_reverse")}
    assert names == want
    ref = torch.nn.GRU(E, E, batch_first=True, bidirectional=True)
    assert {n: tuple(p.shape) for n, p in ref.named_parameters()} == \
        {n[len("agg."):]: tuple(p.shape) for n, p in pm.named_parameters()}
    # and the same numbers as torch's own GRU from the same parameters
    pm.agg.load_state_dict(ref.state_dict())
    x = torch.randn((B, T1, E), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, h_n = ref(x)
        got = pm(x)
    torch.testing.assert_close(got[:, 0], h_n[0] + h_n[1], atol=1e-5, rtol=1e-5)


def test_temporal_index_maps_match_reference():
    from vct_tpu.models import embeddings as je

    for lengths in ([10, 6], [6, 10, 3], [256], [128, 128]):
        np.testing.assert_array_equal(temporal_embedding_indices(lengths),
                                      np.asarray(je.temporal_embedding_indices(lengths)))
        np.testing.assert_array_equal(temporal_encoding(lengths, E),
                                      np.asarray(je.temporal_encoding(lengths, E)))
        sep_p = temporal_encoding(lengths, E, separate=True)
        sep_j = je.temporal_encoding(lengths, E, separate=True)
        assert len(sep_p) == len(sep_j) == len(lengths)
        for a, b in zip(sep_p, sep_j):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("enc_type,layer", [("hmme", [2, 1]), ("simple", 1)])
def test_caption_loss_and_greedy_decode_match_reference(enc_type, layer):
    jm, variables, pm = _pair(_config(enc_type, layer))
    feats, masks, caps, cap_pad = _batch(7)
    jf, jmk = [jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks]
    tf, tmk = [torch.tensor(f) for f in feats], [torch.tensor(m) for m in masks]
    want = jm.apply(variables, jf, jmk, jnp.asarray(caps), jnp.asarray(cap_pad),
                    method=JaxMMT4Caption.caption_loss)
    with torch.no_grad():
        got = pm.caption_loss(tf, tmk, torch.tensor(caps), torch.tensor(cap_pad))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    tok_j, _ = jax_greedy(jm, variables, jf, jmk, max_len=CAP, start_id=2, end_id=-1)
    tok_p, _ = greedy_generate(pm, tf, tmk, max_len=CAP, start_id=2, end_id=-1)
    tok_j = torch.as_tensor(np.asarray(tok_j))
    for row, pos, gap in first_mismatch_gaps(pm, tf, tmk, tok_p, tok_j):
        assert gap < 1e-4, (row, pos, gap)


def test_simple_encoder_is_caption_only_in_the_config():
    from vct_tpu_torch.config import Config

    with pytest.raises(ValueError):
        Config.from_dict({"model": {"video_encoder": {"type": "simple"}},
                          "train": {"task": "cross"}})


def test_fast_decode_weights_extract_for_every_encoder_family():
    """The decode kernels' weight extraction reads the decoder only: it works
    whatever the encoder, and the kernel route decodes the same tokens."""
    from vct_tpu_torch.decode_fast import greedy_generate_fused

    for enc_type, layer in (("hmme", [2, 1]), ("simple", 1)):
        _, _, pm = _pair(_config(enc_type, layer))
        feats, masks, _, _ = _batch(9)
        tf, tmk = [torch.tensor(f) for f in feats], [torch.tensor(m) for m in masks]
        want, _ = greedy_generate(pm, tf, tmk, max_len=CAP, start_id=2, end_id=-1)
        got, _ = greedy_generate_fused(pm, tf, tmk, max_len=CAP, start_id=2, end_id=-1)
        for row, pos, gap in first_mismatch_gaps(pm, tf, tmk, got, want):
            assert gap < 1e-4, (enc_type, row, pos, gap)
