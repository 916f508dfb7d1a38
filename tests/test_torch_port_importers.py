"""The BERT-embedding and UniVL-decoder importers of the port against
``vct_tpu.convert`` (the cases of ``tests/test_importers.py``): the same
tables into both packages give the same weights, exactly (the importers copy
values; nothing is computed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.config import ModelConfig as JModelConfig
from vct_tpu.config import TPUConfig as JTPUConfig
from vct_tpu.convert import import_bert_embeddings as j_import_bert
from vct_tpu.convert import import_univl_decoder as j_import_univl
from vct_tpu.convert import univl_to_reference_keys as j_univl_keys
from vct_tpu.models.mmt4caption import MMT4Caption as JaxModel
from vct_tpu_torch.config import ModelConfig, TPUConfig
from vct_tpu_torch.convert import (
    import_bert_embeddings,
    import_univl_decoder,
    load_state_dict_into,
    state_dict_from_jax,
    univl_to_reference_keys,
)
from vct_tpu_torch.models.mmt4caption import MMT4Caption

from tests.test_importers import E, FF, L, V, _fake_univl

MODEL = {
    "modal": ["a"], "modal_shape": [8], "embed_dim": E, "dropout": 0.0, "vocab_size": V,
    "video_encoder": {"layer": 1, "nhead": 2, "feedforward": FF,
                      "mme": {"temporal": "encoding", "aggregation": "avg"}},
    "caption_decoder": {"layer": L, "nhead": 2, "feedforward": FF},
}
POS = "cap_decoder.positional_encoding.pos_embedding"


@pytest.fixture(scope="module")
def variables():
    m = JaxModel(JModelConfig.from_dict(MODEL), JTPUConfig(dtype="float32"))
    caps = jnp.zeros((1, 5), jnp.int32).at[:, 0].set(2)
    return jax.tree_util.tree_map(np.array, m.init(
        jax.random.PRNGKey(0), [jnp.zeros((1, 3, 8))], [jnp.zeros((1, 3), bool)], caps,
        caps == 0, method=JaxModel.caption_loss))


def port_model(variables):
    model = MMT4Caption(ModelConfig.from_dict(MODEL), TPUConfig(dtype="float32"))
    assert load_state_dict_into(model, state_dict_from_jax(variables)) == {
        "missing": [], "unexpected": []}
    return model


def assert_same_weights(model, jax_variables):
    want = state_dict_from_jax(jax_variables)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("rows", [None, 512])
def test_import_bert_embeddings_matches_reference(variables, rows):
    """The full position table, and a real BERT checkpoint's 512-row table,
    which fills the first rows of the 5000-row buffer and keeps the rest."""
    rng = np.random.default_rng(4)
    pos_rows = variables["buffers"]["cap_decoder"]["positional_encoding"][
        "pos_embedding"].shape[0] if rows is None else rows
    bert = {"embeddings.word_embeddings.weight": rng.standard_normal((V, E)).astype(np.float32),
            "embeddings.position_embeddings.weight": rng.standard_normal(
                (pos_rows, E)).astype(np.float32)}
    model = port_model(variables)
    before = model.state_dict()[POS].clone()
    report = import_bert_embeddings(model, {k: torch.tensor(v) for k, v in bert.items()})
    assert report["unexpected"] == []
    assert set(report["missing"]) == set(model.state_dict()) - {
        "cap_decoder.tgt_to_emb.weight", POS}
    assert_same_weights(model, j_import_bert(variables, bert))
    after = model.state_dict()[POS]
    assert torch.equal(after[:pos_rows], torch.tensor(bert[
        "embeddings.position_embeddings.weight"]))
    assert torch.equal(after[pos_rows:], before[pos_rows:])


def test_univl_key_remap_matches_reference():
    sd = _fake_univl(np.random.default_rng(1))
    got, want = univl_to_reference_keys(sd), j_univl_keys(sd)
    assert set(got) == set(want)
    assert f"cap_decoder.decoder.layers.{L - 1}.self_attn.in_proj_weight" in got
    assert f"cap_decoder.decoder.layers.{L}.self_attn.in_proj_weight" not in got
    for k, v in want.items():
        assert torch.equal(got[k], torch.tensor(v)), k
    # tensors in, as torch.load gives them: the same keys and values
    from_tensors = univl_to_reference_keys({k: torch.tensor(v) for k, v in sd.items()})
    assert all(torch.equal(from_tensors[k], got[k]) for k in got)


def test_import_univl_decoder_matches_reference(variables):
    sd = _fake_univl(np.random.default_rng(2))
    model = port_model(variables)
    report = import_univl_decoder(model, sd)
    assert report["unexpected"] == []
    assert report["missing"] and all(not k.startswith("cap_decoder.")
                                     for k in report["missing"])
    assert_same_weights(model, j_import_univl(variables, sd))
    assert torch.equal(model.cap_decoder.generator.weight,
                       torch.tensor(sd["decoder.classifier.cls.predictions.decoder.weight"]))


def test_trainer_imports_univl_before_the_pretrained_model(tmp_path):
    """``caption_decoder.univl`` in the config: the Trainer imports the
    decoder at build; a ``pretrained_model`` is loaded after it and wins
    (the reference's load order)."""
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.train.loop import Trainer

    sd = _fake_univl(np.random.default_rng(3))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "univl.pth")
    feat_dir = tmp_path / "feats"
    feat_dir.mkdir()
    np.save(feat_dir / "vid0.npy", np.zeros((3, 8), np.float32))
    (tmp_path / "ann.txt").write_text("vid0 a cap")
    (tmp_path / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                  + [f"w{i}" for i in range(V - 5)]))
    split = {"feat_dir": [str(feat_dir)], "annotation_path": str(tmp_path / "ann.txt"),
             "dataset": "msvd", "mode": "by_caption", "split_mode": "train",
             "batch_size": 1}
    model = dict(MODEL, caption_decoder=dict(MODEL["caption_decoder"],
                                             univl=str(tmp_path / "univl.pth")))
    cfg = {"data": {"train": split},
           "train": {"task": "caption", "optimizer": {"name": "adam", "learning_rate": 1e-3},
                     "epoch": 1, "save_dir": str(tmp_path / "c"),
                     "log_dir": str(tmp_path / "l"), "tag": "u"},
           "model": model,
           "tpu": {"max_frames": 3, "max_caption_len": 8, "dtype": "float32",
                   "vocab_path": str(tmp_path / "vocab.txt"), "progress_bar": False}}
    logs = []
    tr = Trainer(Config.from_dict(cfg), device=torch.device("cpu"), log=logs.append)
    assert any("imported UniVL decoder" in line for line in logs)
    want = univl_to_reference_keys(sd)
    got = tr.model.state_dict()
    for k, v in want.items():
        if k == POS:  # the 5000-row table fills the whole buffer
            v = v[: got[k].shape[0]]
        assert torch.equal(got[k], v), k
    # a pretrained model is loaded after the import and wins
    other = {k: torch.zeros_like(v) for k, v in got.items()}
    torch.save(other, tmp_path / "pre.pth")
    cfg["model"] = dict(model, pretrained_model=str(tmp_path / "pre.pth"))
    tr = Trainer(Config.from_dict(cfg), device=torch.device("cpu"), log=logs.append)
    assert not tr.model.cap_decoder.generator.weight.any()
