"""The port's CLIP package against ``vct_tpu.clip`` on the CPU: the vision
and text towers on weights carried across by ``clip_state_dict_from_jax`` /
``clip_text_state_dict_from_jax``, the OpenAI and HF checkpoint layouts, the
BPE tokenizer, frame sampling and preprocessing, and the frozen text encoder.

Tolerance: float32 towers at rtol = atol = 2e-4, the reference's own tower
test (``tests/test_clip.py``), and 3e-4 against HF's text model, the
reference's own text test (``tests/test_clip_text.py``); the tokenizer,
frame indices and sampled frames exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.clip import text as jtext
from vct_tpu.clip import vision as jvision
from vct_tpu.clip.convert import convert_clip as j_convert_clip
from vct_tpu.clip.frames import frame_indices as j_frame_indices
from vct_tpu.clip.frames import sample_frames as j_sample_frames
from vct_tpu_torch.clip import text as ptext
from vct_tpu_torch.clip.convert import (
    clip_state_dict_from_jax,
    clip_text_state_dict_from_jax,
    convert_clip,
    load_clip_state_dict,
)
from vct_tpu_torch.clip.frames import frame_indices, parse_ext_type, sample_frames
from vct_tpu_torch.clip.vision import CLIPVisionTower, init_clip_weights, preprocess_frames

from tests.test_clip_text import _make_bpe_files
from tests.test_pipeline import _random_openai_clip_sd, _write_video

TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_params(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.array, params)


@pytest.mark.parametrize("width,layers,heads", [(64, 1, 2), (64, 2, 2), (768, 2, 12)])
def test_vision_tower_matches_reference(width, layers, heads):
    imgs = np.random.default_rng(width + layers).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    jt = jvision.CLIPVisionTower(width=width, layers=layers, heads=heads,
                                 out_dim=16 if width == 64 else 512)
    params = _jax_params(jt, imgs)
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(imgs)))
    pt = CLIPVisionTower(width=width, layers=layers, heads=heads, out_dim=want.shape[1])
    pt.load_state_dict(clip_state_dict_from_jax(params))  # strict: every key carried
    with torch.no_grad():
        got = pt(torch.tensor(imgs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_openai_layout_loads_strictly_and_matches_reference(tmp_path):
    """An OpenAI ``visual.*`` checkpoint (with text keys beside it) as an
    .npz: strict load, and the reference's converter gives the same tower."""
    sd = _random_openai_clip_sd(np.random.default_rng(2), width=64, layers=2, out=16)
    sd["logit_scale"] = np.ones((), np.float32)
    sd["token_embedding.weight"] = np.zeros((10, 64), np.float32)
    np.savez(tmp_path / "clip.npz", **sd)
    pt = CLIPVisionTower(width=64, layers=2, heads=2, out_dim=16)
    loaded = load_clip_state_dict(str(tmp_path / "clip.npz"))
    result = pt.load_state_dict(convert_clip(loaded, layers=2))
    assert not result.missing_keys and not result.unexpected_keys
    imgs = np.random.default_rng(3).standard_normal((2, 224, 224, 3)).astype(np.float32)
    jt = jvision.CLIPVisionTower(width=64, layers=2, heads=2, out_dim=16)
    want = np.asarray(jt.apply({"params": j_convert_clip(sd, layers=2)}, jnp.asarray(imgs)))
    with torch.no_grad():
        got = pt(torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # only the first `layers` blocks are read, as the reference reads them
    assert set(convert_clip(loaded, layers=1)) < set(convert_clip(loaded))


def test_hf_layout_loads_strictly_and_matches_hf():
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    cfg = CLIPVisionConfig(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=2, image_size=224, patch_size=32,
                           projection_dim=16, hidden_act="quick_gelu")
    torch.manual_seed(0)
    ref = CLIPVisionModelWithProjection(cfg).eval()
    pt = CLIPVisionTower(width=64, layers=2, heads=2, out_dim=16)
    result = pt.load_state_dict(convert_clip(ref.state_dict()))
    assert not result.missing_keys and not result.unexpected_keys
    imgs = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got = pt(torch.tensor(imgs)).numpy()
        want = ref(pixel_values=torch.tensor(imgs.transpose(0, 3, 1, 2))).image_embeds.numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _tokens(vocab, rng, eot_at=(10, 30, 76)):
    toks = rng.integers(1, vocab - 1, (len(eot_at), 77)).astype(np.int32)
    toks[:, 0] = 0
    for r, pos in enumerate(eot_at):
        toks[r, pos] = vocab - 1  # EOT = the highest id: argmax pooling
    return toks


def test_text_tower_matches_reference():
    vocab = 100
    toks = _tokens(vocab, np.random.default_rng(0))
    jt = jtext.CLIPTextTower(vocab_size=vocab, width=64, layers=2, heads=2, out_dim=32)
    params = _jax_params(jt, toks)
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(toks)))
    pt = ptext.CLIPTextTower(vocab_size=vocab, width=64, layers=2, heads=2, out_dim=32)
    pt.load_state_dict(clip_text_state_dict_from_jax(params))
    with torch.no_grad():
        got = pt(torch.tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_text_hf_and_openai_layouts_load_strictly():
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    vocab = 100
    cfg = CLIPTextConfig(vocab_size=vocab, hidden_size=64, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=77, projection_dim=32,
                         hidden_act="quick_gelu", eos_token_id=vocab - 1)
    torch.manual_seed(0)
    ref = CLIPTextModelWithProjection(cfg).eval()
    hf_sd = ref.state_dict()
    openai_sd = ptext._hf_text_to_openai(hf_sd)
    for sd in (hf_sd, openai_sd):
        assert ptext.infer_text_tower_kwargs(sd) == jtext.infer_text_tower_kwargs(
            {k: v.numpy() for k, v in sd.items()})
        pt = ptext.CLIPTextTower(vocab_size=vocab, width=64, layers=2, heads=2, out_dim=32)
        result = pt.load_state_dict(ptext.convert_clip_text(sd))
        assert not result.missing_keys and not result.unexpected_keys
        toks = _tokens(vocab, np.random.default_rng(1))
        with torch.no_grad():
            got = pt(torch.tensor(toks)).numpy()
            want = ref(input_ids=torch.tensor(toks.astype(np.int64))).text_embeds.numpy()
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_bpe_tokenizer_equals_the_reference(tmp_path):
    vocab_json, merges_txt = _make_bpe_files(tmp_path)
    texts = ["hello world", "hello", "a man rides!", "it's 7 o'clock", "Hello   WORLD  ",
             "don't stop--now", "&amp; html", "###", "#hi#", "hello " * 100]
    for make in ("from_hf_files", "from_openai_merges"):
        args = (vocab_json, merges_txt) if make == "from_hf_files" else (merges_txt,)
        ours = getattr(ptext.CLIPBPETokenizer, make)(*args)
        theirs = getattr(jtext.CLIPBPETokenizer, make)(*args)
        assert ours.encoder == theirs.encoder and ours.bpe_ranks == theirs.bpe_ranks
        for text in texts:
            assert ours.encode(text) == theirs.encode(text), text
        np.testing.assert_array_equal(ours.tokenize(texts), theirs.tokenize(texts))
        np.testing.assert_array_equal(ours.tokenize(texts, context_length=10),
                                      theirs.tokenize(texts, context_length=10))
    with pytest.raises(ValueError, match="too long"):
        ours.tokenize(["hello " * 100], truncate=False)


def test_text_encoder_equals_the_reference(tmp_path):
    """The table is sized as the reference's own test sizes it
    (``tests/test_text_encoder_integration.py``): by the number of tokens in
    ``vocab.json``. The ids of ``_make_bpe_files`` run past it (merge results
    repeat some byte tokens), so the captions reach past the table, and both
    lookups clamp such an id to the last row."""
    from tests.test_text_encoder_integration import _tiny_clip_text_npz

    vocab_json, merges_txt = _make_bpe_files(tmp_path)
    vocab = json.loads((tmp_path / "vocab.json").read_text())
    n_vocab = len(vocab)
    assert max(vocab.values()) >= n_vocab
    _tiny_clip_text_npz(tmp_path / "t.npz", np.random.default_rng(0), vocab=n_vocab)
    kw = dict(clip_weights=str(tmp_path / "t.npz"), vocab_json=vocab_json,
              merges_txt=merges_txt)
    captions = ["hello world", "hello", "world hello world"]
    assert (ptext.CLIPBPETokenizer.from_hf_files(vocab_json, merges_txt)
            .tokenize(captions) >= n_vocab).any()
    want = jtext.build_text_encoder("CLIP", batch_pad=4, **kw)(captions)
    enc = ptext.build_text_encoder("CLIP", device=torch.device("cpu"), **kw)
    got = enc(captions)
    assert got.dtype == torch.float32 and got.shape == (3, 512)
    assert not enc.tower.training and not any(p.requires_grad for p in enc.tower.parameters())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():
        past, last = (enc.tower(torch.full((1, 77), i)) for i in (n_vocab, n_vocab - 1))
    np.testing.assert_array_equal(past.numpy(), last.numpy())
    with pytest.raises(ValueError, match="clip_weights"):
        ptext.build_text_encoder("CLIP", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="unsupported"):
        ptext.build_text_encoder("word2vec", device=torch.device("cpu"))


@pytest.mark.parametrize("ext_type", ["uni_12", "uni_4", "fps_5", "fps_30", "fix_20",
                                      "fix_1", "tsn_12", "tsn_7"])
@pytest.mark.parametrize("n", [1, 3, 40, 101])
def test_frame_indices_equal_the_reference(ext_type, n):
    np.testing.assert_array_equal(frame_indices(n, 25.0, ext_type),
                                  j_frame_indices(n, 25.0, ext_type))


def test_sampling_and_preprocessing_equal_the_reference(tmp_path):
    _write_video(tmp_path / "v.avi", n_frames=30)
    for ext_type in ("uni_12", "tsn_4", "fps_5"):
        got = sample_frames(str(tmp_path / "v.avi"), ext_type)
        np.testing.assert_array_equal(got, j_sample_frames(str(tmp_path / "v.avi"), ext_type))
    np.testing.assert_array_equal(preprocess_frames(got), jvision.preprocess_frames(got))
    for bad in ("uni", "blah_3", "uni_0", "uni_x"):
        with pytest.raises(ValueError):
            parse_ext_type(bad)
    with pytest.raises(FileNotFoundError):
        sample_frames(str(tmp_path / "missing.avi"))


def test_init_is_seeded_and_device_independent():
    a = init_clip_weights(CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16),
                          torch.Generator().manual_seed(0))
    b = init_clip_weights(CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16),
                          torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.equal(a.ln_pre.weight, torch.ones(64))
    assert torch.equal(a.transformer.resblocks[0].attn.in_proj_bias, torch.zeros(192))
