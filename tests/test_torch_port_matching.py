"""The matching and cross tasks of the port against ``vct_tpu`` on the CPU:
the contrastive losses (CSL, CSL_WDS; ``valid`` masking, temperature), the
``Matching`` head with and without ``v_proj``, the model's ``match_loss`` /
``cross_loss`` values and gradients against ``jax.value_and_grad``, the
train and eval steps, and the Trainer on each task with the frozen CLIP text
encoder.

Tolerance: float32. Losses and their input gradients at rtol = atol = 1e-5
(one small matrix product apart); the model's losses at 1e-4 relative and
its gradients within 1e-4 of each tensor's largest value (two frameworks
summing a few layers in different orders, as ``test_torch_port_train.py``);
Trainer losses at 2e-4 relative (a few Adam steps on top).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.config import Config as JConfig
from vct_tpu.config import ModelConfig as JModelConfig
from vct_tpu.config import TPUConfig as JTPUConfig
from vct_tpu.models import losses as jl
from vct_tpu.models.matching import Matching as JMatching
from vct_tpu.models.mmt4caption import MMT4Caption as JaxModel
from vct_tpu_torch.config import Config, ModelConfig, TPUConfig
from vct_tpu_torch.convert import load_state_dict_into, state_dict_from_jax
from vct_tpu_torch.models import losses as pl
from vct_tpu_torch.models.matching import Matching
from vct_tpu_torch.models.mmt4caption import MMT4Caption, text_encoder_dim

from tests.test_clip_text import _make_bpe_files
from tests.test_text_encoder_integration import _tiny_clip_text_npz

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
B, D = 6, 16
VALID = np.arange(B) < 4  # rows 4 and 5 are collate filler


def _feats(seed):
    rng = np.random.default_rng(seed)
    video, text = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    video[4:], text[4:] = video[0], text[0]  # filler rows repeat row 0
    return video, text


@pytest.mark.parametrize("name", ["clip_symmetric_loss", "clip_symmetric_loss_wds"])
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("tem", [None, 0.7])
def test_contrastive_losses_and_gradients_match_reference(name, valid, tem):
    video, text = _feats(0)
    v = VALID if valid else None
    t = None if tem is None else np.asarray([tem], np.float32)

    def j_loss(a, b):
        return getattr(jl, name)(a, b, None if t is None else jnp.asarray(t),
                                 None if v is None else jnp.asarray(v))

    want, (gv, gt) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(video),
                                                                 jnp.asarray(text))
    a, b = torch.tensor(video, requires_grad=True), torch.tensor(text, requires_grad=True)
    got = getattr(pl, name)(a, b, None if t is None else torch.tensor(t),
                            None if v is None else torch.tensor(v))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gv), **LOSS_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gt), **LOSS_TOL)
    if valid:
        # the valid sub-batch alone, without a mask: the same loss
        sub = getattr(pl, name)(torch.tensor(video[:4]), torch.tensor(text[:4]),
                                None if t is None else torch.tensor(t))
        np.testing.assert_allclose(float(got), float(sub), **LOSS_TOL)


@pytest.mark.parametrize("video_dim", [D, 24])
@pytest.mark.parametrize("loss,enable_tem,fixed_tem", [("CSL", False, None),
                                                       ("CSL", True, None),
                                                       ("CSL_WDS", False, 0.5),
                                                       ("CSL_WDS", True, None)])
def test_matching_head_matches_reference(video_dim, loss, enable_tem, fixed_tem):
    rng = np.random.default_rng(1)
    video = rng.standard_normal((B, video_dim)).astype(np.float32)
    text = rng.standard_normal((B, D)).astype(np.float32)
    jm = JMatching(video_dim=video_dim, text_dim=D, loss=loss, enable_tem=enable_tem,
                   fixed_tem=fixed_tem)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(video)).get(
        "params", {})  # none without v_proj and temperature
    if enable_tem:  # away from its init of 1
        params = dict(params, temperature=jnp.asarray([0.3]))
    want = jm.apply({"params": params}, jnp.asarray(text), jnp.asarray(video),
                    jnp.asarray(VALID))
    pm = Matching(video_dim, D, loss, enable_tem, fixed_tem)
    pm.load_state_dict(state_dict_from_jax({"params": params}))  # strict
    assert (pm.v_proj is None) == (video_dim == D)
    assert ("loss_fn.temperature" in pm.state_dict()) == enable_tem
    got = pm(torch.tensor(text), torch.tensor(video), torch.tensor(VALID))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    with pytest.raises(ValueError, match="unsupported matching loss"):
        Matching(video_dim, D, "MSE")


# ---------------------------------------------------------------------------
# the model's match and cross tasks
# ---------------------------------------------------------------------------

T, D_FEAT, E, VOCAB, S = 5, 24, 32, 50, 9


def model_config(matching):
    return {
        "modal": ["m0"], "modal_shape": [D_FEAT], "embed_dim": E, "dropout": 0.0,
        "vocab_size": VOCAB, "activation": "gelu", "text_enc_type": "CLIP",
        "loss_beta": 0.3, "matching": matching,
        "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                          "mme": {"temporal": "encoding", "aggregation": "avg"}},
        "caption_decoder": {"layer": 2, "nhead": 2, "feedforward": 64},
    }


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, D_FEAT)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[1, -2:] = True
    ids = np.zeros((B, S), np.int32)
    for r in range(B):
        n = int(rng.integers(3, S - 2))
        ids[r, 0], ids[r, 1:n + 1], ids[r, n + 1] = 2, rng.integers(5, VOCAB, n), 3
    text = rng.standard_normal((B, 512)).astype(np.float32)
    feats[4:], pad[4:], ids[4:], text[4:] = feats[0], pad[0], ids[0], text[0]
    return feats, pad, ids, ids == 0, text, VALID


def build_pair(matching):
    cfg = model_config(matching)
    jm = JaxModel(JModelConfig.from_dict(cfg), JTPUConfig(dtype="float32"))
    feats, pad, ids, idpad, text, valid = make_batch()
    variables = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(3), [jnp.asarray(feats)], [jnp.asarray(pad)], jnp.asarray(ids),
        jnp.asarray(idpad), jnp.asarray(text), method=JaxModel.cross_loss))
    if matching.get("enable_tem"):
        variables["params"]["matching"]["temperature"] = np.asarray([0.4], np.float32)
    pm = MMT4Caption(ModelConfig.from_dict(cfg), TPUConfig(dtype="float32"))
    # the JAX model with matching.* params: nothing missing, nothing unexpected
    assert load_state_dict_into(pm, state_dict_from_jax(variables)) == {
        "missing": [], "unexpected": []}
    return jm, variables, pm.eval()


MATCHINGS = [{"enable_tem": False, "matching_loss": "CSL"},
             {"enable_tem": True, "matching_loss": "CSL_WDS"},
             {"enable_tem": False, "matching_loss": "CSL", "temperature": 0.2}]


@pytest.mark.parametrize("task", ["match", "cross"])
@pytest.mark.parametrize("matching", MATCHINGS, ids=["csl", "wds_tem", "csl_fixed"])
def test_task_losses_and_gradients_match_reference(task, matching):
    jm, variables, pm = build_pair(matching)
    feats, pad, ids, idpad, text, valid = make_batch(seed=1)
    j = [jnp.asarray(a) for a in (feats, pad, ids, idpad, text, valid)]

    def loss_fn(params):
        v = {"params": params, "buffers": variables["buffers"]}
        if task == "match":
            out = jm.apply(v, [j[0]], [j[1]], j[4], row_valid=j[5],
                           method=JaxModel.match_loss)
            return out, (out,)
        out = jm.apply(v, [j[0]], [j[1]], j[2], j[3], j[4], row_valid=j[5],
                       method=JaxModel.cross_loss)
        return out[0], out

    (loss_j, outs_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    grads_j = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads_j)})
    t = [torch.tensor(a) for a in (feats, pad, ids, idpad, text, valid)]
    if task == "match":
        outs_p = (pm.match_loss([t[0]], [t[1]], t[4], row_valid=t[5]),)
    else:
        outs_p = pm.cross_loss([t[0]], [t[1]], t[2], t[3], t[4], row_valid=t[5])
    outs_p[0].backward()
    np.testing.assert_allclose([float(o) for o in outs_p], [float(o) for o in outs_j],
                               rtol=1e-4)
    if task == "cross":  # beta * cap + (1 - beta) * match
        np.testing.assert_allclose(float(outs_p[0]),
                                   0.3 * float(outs_p[1]) + 0.7 * float(outs_p[2]), rtol=1e-6)
    got = {k: p.grad for k, p in pm.named_parameters() if p.grad is not None}
    want = {k: g for k, g in grads_j.items() if np.abs(g.numpy()).max() > 0}
    assert set(want) <= set(got)
    for k, g in got.items():
        ref = grads_j[k].numpy().ravel()
        scale = np.abs(ref).max()
        assert np.abs(g.numpy().ravel() - ref).max() <= 1e-4 * scale + 1e-12, k
    if task == "match":  # the caption decoder takes no part
        assert not any(k.startswith("cap_decoder.") for k in got)
    if task == "cross":
        parts_j = jm.apply(variables, [j[0]], [j[1]], j[2], j[3], j[4], row_valid=j[5],
                           method=JaxModel.cross_loss_parts)
        with torch.no_grad():
            parts_p = pm.cross_loss_parts([t[0]], [t[1]], t[2], t[3], t[4], row_valid=t[5])
        np.testing.assert_allclose([float(p) for p in parts_p], [float(p) for p in parts_j],
                                   rtol=1e-4)


def test_text_encoder_dim_and_missing_head():
    assert text_encoder_dim("CLIP") == 512 and text_encoder_dim("bert-base-uncased") == 768
    with pytest.raises(ValueError, match="unsupported"):
        text_encoder_dim("word2vec")
    pm = MMT4Caption(ModelConfig.from_dict(model_config(None)), TPUConfig(dtype="float32"))
    assert pm.matching is None and not any(k.startswith("matching.")
                                           for k in pm.state_dict())
    feats, pad, _, _, text, valid = (torch.tensor(a) for a in make_batch())
    with pytest.raises(ValueError, match="model.matching"):
        pm.match_loss([feats], [pad], text, row_valid=valid)
    # init_weights reaches the head: unit temperature, seeded projection
    pm = MMT4Caption(ModelConfig.from_dict(model_config(MATCHINGS[1])),
                     TPUConfig(dtype="float32")).init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(pm.matching.loss_fn.temperature, torch.ones(1))
    assert pm.matching.v_proj.weight.shape == (512, E) and pm.matching.v_proj.weight.std() > 0


# ---------------------------------------------------------------------------
# steps and the Trainer, with the frozen CLIP text encoder
# ---------------------------------------------------------------------------

N_VID = 6


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_match_ws")
    vocab_json, merges_txt = _make_bpe_files(root)
    n_vocab = max(json.loads((root / "vocab.json").read_text()).values()) + 1
    _tiny_clip_text_npz(root / "clip_text.npz", np.random.default_rng(0), vocab=n_vocab)
    (root / "feats").mkdir()
    rng = np.random.default_rng(1)
    lines = []
    for i in range(N_VID):
        np.save(root / "feats" / f"vid{i}.npy", rng.standard_normal((T, D_FEAT)).astype(
            np.float32))
        lines += [f"vid{i} hello world {i}", f"vid{i} world hello {i % 3}"]
    (root / "ann.txt").write_text("\n".join(lines))
    (root / "wp_vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world"]
        + [str(i) for i in range(N_VID)]))
    return root, vocab_json, merges_txt


def trainer_config(ws, task, pretrained=None):
    root, vocab_json, merges_txt = ws
    split = {"feat_dir": [str(root / "feats")], "annotation_path": str(root / "ann.txt"),
             "dataset": "msvd", "mode": "by_caption", "split_mode": "train", "batch_size": 4}
    model = dict(model_config(MATCHINGS[1]), modal=["CLIP4Clip"],
                 pretrained_model=pretrained)
    return {
        "data": {"train": split, "validation": dict(split, split_mode="validate"),
                 "eval": dict(split, mode="by_video", split_mode="validate", batch_size=2)},
        "train": {"task": task, "optimizer": {"name": "adam", "learning_rate": 1e-3},
                  "epoch": 1, "save_dir": str(root / f"ckpt_{task}"),
                  "log_dir": str(root / "log"), "tag": task, "metric_earlystop": False},
        "test": {"max_length": 6},
        "model": model,
        "tpu": {"max_frames": T, "max_caption_len": 8, "dtype": "float32", "mesh_data": 1,
                "vocab_path": str(root / "wp_vocab.txt"), "progress_bar": False,
                "clip_text_weights": str(root / "clip_text.npz"),
                "clip_vocab_json": vocab_json, "clip_merges_txt": merges_txt},
    }


@pytest.mark.parametrize("task", ["match", "cross"])
def test_trainer_epoch_matches_reference(workspace, task, tmp_path):
    """Both Trainers from one reference-keyed .pth (with matching.*), the
    text encoder each builds from tpu.clip_text_weights, dropout 0: the same
    validation losses before training, the same mean loss over an epoch of
    Adam steps, the same validation losses after it. The match task leaves the
    caption decoder as it was."""
    from vct_tpu.train.loop import Trainer as JTrainer
    from vct_tpu_torch.train.loop import Trainer

    seed_cfg = Config.from_dict(trainer_config(workspace, task))
    quiet = lambda *_: None  # noqa: E731
    seeded = Trainer(seed_cfg, device=torch.device("cpu"), log=quiet)
    torch.save(seeded.model.state_dict(), tmp_path / "w.pth")
    cfg_d = trainer_config(workspace, task, pretrained=str(tmp_path / "w.pth"))
    port = Trainer(Config.from_dict(json.loads(json.dumps(cfg_d))), device=torch.device("cpu"),
                   log=quiet)
    ref = JTrainer(JConfig.from_dict(json.loads(json.dumps(cfg_d))), log=quiet)
    decoder_before = {k: v.clone() for k, v in port.model.state_dict().items()
                      if k.startswith("cap_decoder.")}
    for when in ("before", "after"):
        if when == "after":
            got, want = port.train_epoch(0), ref.train_epoch(0)
            assert np.isfinite(got)
            np.testing.assert_allclose(got, want, rtol=2e-4)
        got, want = port.val_epoch(), ref.val_epoch()
        assert set(got) == set(want) == ({"loss", "match_loss"} if task == "match"
                                         else {"loss", "match_loss", "cap_loss"})
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=f"{when} {k}")
    after = port.model.state_dict()
    moved = [k for k, v in decoder_before.items() if not torch.equal(after[k], v)]
    assert (moved == []) == (task == "match")
    assert set(port.fit()) >= {"Bleu_4", "CIDEr"}


def test_trainer_needs_a_text_encoder_for_match(workspace):
    from vct_tpu_torch.train.loop import Trainer

    cfg_d = trainer_config(workspace, "match")
    cfg_d["tpu"]["clip_text_weights"] = None
    with pytest.raises(ValueError, match="text_encoder"):
        Trainer(Config.from_dict(cfg_d), device=torch.device("cpu"))
    # one passed in is used as it is
    calls = []

    def encoder(captions):
        calls.append(len(captions))
        return torch.ones((len(captions), 512))

    tr = Trainer(Config.from_dict(cfg_d), device=torch.device("cpu"), text_encoder=encoder,
                 log=lambda *_: None)
    assert np.isfinite(tr.train_epoch(0)) and calls and set(calls) <= {4}
