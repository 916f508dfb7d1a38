"""The PyTorch port's modules against the JAX reference, in float32 on the CPU.

Both packages get the same weights (the JAX init carried across through
``vct_tpu_torch.convert.state_dict_from_jax``) and the same numpy inputs.
Tolerance: atol = rtol = 1e-4 — the two frameworks sum in different orders
and flax computes LayerNorm variance as E[x^2] - E[x]^2, so agreement is to
float32 rounding over a few layers, not bit-exact.

The helpers here are shared by the other ``test_torch_port_*`` files.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.config import ModelConfig, TPUConfig
from vct_tpu.convert import convert_state_dict
from vct_tpu.models.mmt4caption import MMT4Caption as JaxMMT4Caption
from vct_tpu_torch.convert import load_state_dict_into, state_dict_from_jax
from vct_tpu_torch.models.mmt4caption import MMT4Caption

B, T, D_FEAT, E, H, FF, VOCAB, MAX_LEN = 4, 6, 24, 128, 4, 256, 300, 10
TOL = dict(atol=1e-4, rtol=1e-4)


def model_config(dec_layers=2, modal_shape=(D_FEAT,)):
    return ModelConfig.from_dict({
        "modal": [f"m{i}" for i in range(len(modal_shape))],
        "modal_shape": list(modal_shape), "embed_dim": E, "dropout": 0.0,
        "vocab_size": VOCAB, "activation": "gelu",
        "video_encoder": {"layer": 1, "nhead": H, "feedforward": FF,
                          "mme": {"temporal": "encoding", "aggregation": "avg"}},
        "caption_decoder": {"layer": dec_layers, "nhead": H, "feedforward": FF,
                            "sce_loss_alpha": 0.5},
    })


def make_inputs(seed=0, modal_shape=(D_FEAT,)):
    """Per-modality features [B, T, D] and pad masks (row 1 ends in 2 pads)."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, T, d)).astype(np.float32) for d in modal_shape]
    pad = np.zeros((B, T), bool)
    pad[1, -2:] = True
    return feats, [pad.copy() for _ in modal_shape]


@functools.lru_cache(maxsize=None)
def _jax_init(dec_layers, modal_shape, seed):
    cfg = model_config(dec_layers, modal_shape)
    feats, masks = make_inputs(modal_shape=modal_shape)
    caps = jnp.zeros((B, MAX_LEN), jnp.int32)
    variables = JaxMMT4Caption(cfg, TPUConfig()).init(
        jax.random.PRNGKey(seed), [jnp.asarray(f) for f in feats],
        [jnp.asarray(m) for m in masks], caps, caps == 0,
        method=JaxMMT4Caption.caption_loss)
    return jax.tree_util.tree_map(np.asarray, variables)


def build_pair(dec_layers=2, quirk=False, modal_shape=(D_FEAT,), seed=3):
    """(jax model, jax variables, port model) with identical float32 weights;
    the variables are writeable copies of one cached init per shape."""
    cfg = model_config(dec_layers, modal_shape)
    tpu = TPUConfig(quirk_no_memory_mask_in_decoder=quirk, dtype="float32")
    jm = JaxMMT4Caption(cfg, tpu)
    variables = jax.tree_util.tree_map(np.array, _jax_init(dec_layers, modal_shape, seed))
    pm = MMT4Caption(cfg, tpu)
    report = load_state_dict_into(pm, state_dict_from_jax(variables))
    assert not report["missing"] and not report["unexpected"], report
    return jm, variables, pm.eval()


def to_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def to_jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_state_dict_round_trips_through_the_reference_converter(pair):
    jm, variables, pm = pair
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    back, report = convert_state_dict(variables, sd)
    assert report == {"missing": [], "unexpected": []}
    flat_a = jax.tree_util.tree_leaves(variables)
    flat_b = jax.tree_util.tree_leaves(back)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("modal_shape", [(D_FEAT,), (D_FEAT, 16)])
def test_encode_matches_reference(modal_shape):
    jm, variables, pm = build_pair(modal_shape=modal_shape)
    feats, masks = make_inputs(modal_shape=modal_shape)
    mem_j, mask_j, agg_j = jm.apply(variables, to_jax(feats), to_jax(masks),
                                    method=JaxMMT4Caption.encode)
    with torch.no_grad():
        mem_p, mask_p, agg_p = pm.encode(to_torch(feats), to_torch(masks))
    np.testing.assert_allclose(mem_p.numpy(), np.asarray(mem_j), **TOL)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(agg_p.numpy(), np.asarray(agg_j), **TOL)


def test_init_cache_matches_reference(pair):
    jm, variables, pm = pair
    feats, masks = make_inputs()
    mem_j, _, _ = jm.apply(variables, to_jax(feats), to_jax(masks),
                           method=JaxMMT4Caption.encode)
    caches_j = jm.apply(variables, B, MAX_LEN, mem_j, method=JaxMMT4Caption.init_cache)
    with torch.no_grad():
        caches_p = pm.init_cache(B, MAX_LEN, torch.from_numpy(np.asarray(mem_j)))
    assert len(caches_p) == len(caches_j)
    for cj, cp in zip(caches_j, caches_p):
        for key in ("k", "v", "ck", "cv"):
            np.testing.assert_allclose(cp[key].numpy(), np.asarray(cj[key]), **TOL)


@pytest.mark.parametrize("quirk", [False, True])
def test_decode_step_logits_match_reference(quirk):
    """Six cached steps, fed the reference's own argmax tokens."""
    jm, variables, pm = build_pair(quirk=quirk)
    feats, masks = make_inputs()
    mem_j, mmask_j, _ = jm.apply(variables, to_jax(feats), to_jax(masks),
                                 method=JaxMMT4Caption.encode)
    caches_j = jm.apply(variables, B, MAX_LEN, mem_j, method=JaxMMT4Caption.init_cache)
    mem_p = torch.from_numpy(np.asarray(mem_j))
    mmask_p = torch.from_numpy(np.asarray(mmask_j))
    with torch.no_grad():
        caches_p = pm.init_cache(B, MAX_LEN, mem_p)
    tok = np.full((B,), 2, np.int32)
    tok[3] = 0  # a [PAD] input embeds to zero on both sides
    for i in range(6):
        logits_j, caches_j, _ = jm.apply(variables, jnp.asarray(tok), caches_j, i,
                                         mmask_j, method=JaxMMT4Caption.decode_step)
        with torch.no_grad():
            logits_p, caches_p, _ = pm.decode_step(torch.from_numpy(tok), caches_p, i,
                                                   mmask_p)
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), **TOL)
        tok = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)


def test_shorter_position_table_merges_into_the_buffer(pair):
    _, _, pm = pair
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    rows = torch.arange(512 * E, dtype=torch.float32).reshape(512, E)
    sd["cap_decoder.positional_encoding.pos_embedding"] = rows
    before = pm.cap_decoder.positional_encoding.pos_embedding.clone()
    try:
        report = load_state_dict_into(pm, sd)
        pe = pm.cap_decoder.positional_encoding.pos_embedding
        assert report == {"missing": [], "unexpected": []}
        torch.testing.assert_close(pe[:512], rows)
        torch.testing.assert_close(pe[512:], before[512:])
    finally:
        pm.cap_decoder.positional_encoding.pos_embedding.copy_(before)


def test_load_reports_missing_and_unexpected_keys(pair):
    _, _, pm = pair
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    sd.pop("cap_decoder.generator.bias")
    sd["matching.v_proj.weight"] = torch.zeros(3, 3)
    report = load_state_dict_into(pm, sd)
    assert report == {"missing": ["cap_decoder.generator.bias"],
                      "unexpected": ["matching.v_proj.weight"]}


def test_compute_dtype_cast_keeps_layernorms_float32():
    cfg = model_config()
    pm = MMT4Caption(cfg, TPUConfig(), dtype=torch.bfloat16)
    pm.init_weights(torch.Generator().manual_seed(0)).to_compute_dtype()
    dec = pm.cap_decoder.decoder
    assert dec.layers[0].linear1.weight.dtype == torch.bfloat16
    assert dec.norm.weight.dtype == torch.float32
    assert pm.cap_decoder.positional_encoding.pos_embedding.dtype == torch.bfloat16
    feats, masks = make_inputs()
    with torch.no_grad():
        mem, _, _ = pm.encode(to_torch(feats), to_torch(masks))
    assert mem.dtype == torch.bfloat16 and torch.isfinite(mem.float()).all()


def test_teacher_forced_decoder_matches_reference(pair):
    """The decoder stack's full-sequence forward (causal + padding bias, the
    positional table over a prefix) against the reference's caption logits."""
    from vct_tpu_torch.ops.attention import causal_bias, combine_bias, padding_bias

    jm, variables, pm = pair
    feats, masks = make_inputs()
    rng = np.random.default_rng(5)
    ids = rng.integers(5, VOCAB, (B, 7)).astype(np.int32)
    ids[:, 0] = 2
    ids[2, 5:] = 0  # a padded caption
    logits_j, _, _ = jm.apply(variables, to_jax(feats), to_jax(masks), jnp.asarray(ids),
                              jnp.asarray(ids == 0), method=JaxMMT4Caption.caption_logits)
    tgt = torch.from_numpy(ids[:, :-1])
    cd = pm.cap_decoder
    with torch.no_grad():
        memory, mem_mask, _ = pm.encode(to_torch(feats), to_torch(masks))
        bias = combine_bias(causal_bias(tgt.shape[1]), padding_bias(tgt == 0))
        x = cd.positional_encoding(cd.embed(tgt))
        out, _ = cd.decoder(x, memory, bias, cd.memory_bias(mem_mask))
        logits_p = cd.generator(out)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), **TOL)


def test_setup_seed_also_seeds_torch():
    from vct_tpu_torch.utils import setup_seed

    setup_seed(7)
    a = (torch.rand(3), np.random.rand(3))
    setup_seed(7)
    b = (torch.rand(3), np.random.rand(3))
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
