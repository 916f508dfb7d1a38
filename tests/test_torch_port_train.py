"""Caption training of the port against ``vct_tpu``: the whole model's loss
parts and parameter gradients, optimizer steps, and the Trainer.

Both packages get the same weights (one JAX init carried across through
``vct_tpu_torch.convert.state_dict_from_jax``) and the same numpy batch at a
small size: 1 encoder layer, 2 decoder layers, E=128, vocab 1111, 12 captions
of 27 tokens, so the loss sees N = 312 rows and the kernel route of the fused
loss is eligible. Dropout is 0 where the two packages are compared (their
random streams differ); dropout's own tests are at the end.

Tolerances. float32: two frameworks sum in different orders over a few
layers — loss parts 1e-4 relative, gradients 1e-4 of each tensor's largest
value. bfloat16: every product and LayerNorm output rounds to 8 significant
bits, and the frameworks round at slightly different points (flax takes the
LayerNorm variance as E[x^2] - E[x]^2), so parts agree to 1e-2 relative and a
gradient tensor to 12% of its largest value with a cosine above 0.995.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.config import Config as JaxConfig
from vct_tpu.config import ModelConfig, TPUConfig
from vct_tpu.convert import convert_state_dict
from vct_tpu.models.mmt4caption import MMT4Caption as JaxMMT4Caption
from vct_tpu.ops import fused_loss as jfl
from vct_tpu_torch.config import Config
from vct_tpu_torch.convert import load_state_dict_into, state_dict_from_jax
from vct_tpu_torch.models.mmt4caption import MMT4Caption
from vct_tpu_torch.ops import fused_loss as fl

B, T, D_FEAT, E, H, FF, VOCAB, S = 12, 6, 24, 128, 4, 256, 1111, 27


def model_config(dropout=0.0, alpha=0.5):
    return {
        "modal": ["m0"], "modal_shape": [D_FEAT], "embed_dim": E, "dropout": dropout,
        "vocab_size": VOCAB, "activation": "gelu",
        "video_encoder": {"layer": 1, "nhead": H, "feedforward": FF,
                          "mme": {"temporal": "encoding", "aggregation": "avg"}},
        "caption_decoder": {"layer": 2, "nhead": H, "feedforward": FF,
                            "sce_loss_alpha": alpha},
    }


def make_batch(seed=0):
    """feats, frame pad masks, token ids ([CLS]=2 ... [SEP]=3, pad 0), the
    last two rows collate filler (copies of row 0, row_valid False)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, D_FEAT)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[1, -2:] = True
    ids = np.zeros((B, S), np.int32)
    for r in range(B):
        n = int(rng.integers(4, S - 2))  # the longest caption stays under S
        ids[r, 0], ids[r, 1:n + 1], ids[r, n + 1] = 2, rng.integers(5, VOCAB, n), 3
    ids[3, 1] = VOCAB - 1  # a label in the last, partial vocab tile
    feats[-2:], pad[-2:], ids[-2:] = feats[0], pad[0], ids[0]
    valid = np.arange(B) < B - 2
    return feats, pad, ids, ids == 0, valid


def build_pair(dtype="float32", alpha=0.5, seed=3, dropout=0.0, **tpu):
    cfg = ModelConfig.from_dict(model_config(dropout, alpha))
    tcfg = TPUConfig(dtype=dtype, **tpu)
    jm = JaxMMT4Caption(cfg, tcfg, dtype={"float32": jnp.float32,
                                          "bfloat16": jnp.bfloat16}[dtype])
    feats, pad, ids, idpad, _ = make_batch()
    variables = JaxMMT4Caption(cfg, TPUConfig()).init(
        jax.random.PRNGKey(seed), [jnp.asarray(feats)], [jnp.asarray(pad)], jnp.asarray(ids),
        jnp.asarray(idpad), method=JaxMMT4Caption.caption_loss)
    variables = jax.tree_util.tree_map(np.array, variables)
    from vct_tpu_torch.config import ModelConfig as PModelConfig
    from vct_tpu_torch.config import TPUConfig as PTPUConfig

    pm = MMT4Caption(PModelConfig.from_dict(model_config(dropout, alpha)),
                     PTPUConfig(dtype=dtype, **tpu),
                     dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
    report = load_state_dict_into(pm, state_dict_from_jax(variables))
    assert not report["missing"] and not report["unexpected"], report
    return jm, variables, pm


def jax_parts_and_grads(jm, variables, batch):
    feats, pad, ids, idpad, valid = (jnp.asarray(a) for a in batch)
    alpha = jm.config.caption_decoder.sce_loss_alpha

    def loss_fn(params):
        parts = jm.apply({"params": params, "buffers": variables["buffers"]}, [feats], [pad],
                         ids, idpad, row_valid=valid,
                         method=JaxMMT4Caption.caption_loss_parts)
        ce_sum, ce_n, rce_sum, rce_n = parts
        return (alpha * ce_sum / jnp.maximum(ce_n, 1.0)
                + (1.0 - alpha) * rce_sum / jnp.maximum(rce_n, 1.0)), parts

    (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    return float(loss), [float(p) for p in parts], grads


def port_parts_and_grads(pm, batch):
    feats, pad, ids, idpad, valid = (torch.tensor(a) for a in batch)
    pm.eval().zero_grad()
    parts = pm.caption_loss_parts([feats], [pad], ids, idpad, row_valid=valid)
    loss = pm.caption_loss([feats], [pad], ids, idpad, row_valid=valid)
    loss.backward()
    grads = {k: p.grad for k, p in pm.named_parameters()}
    return float(loss), [float(p) for p in parts], grads


@pytest.mark.parametrize("dtype,route,alpha", [
    ("float32", "kernel", 0.5), ("float32", "chunked", 0.5), ("float32", "kernel", 1.0),
    ("float32", "materialised", 0.5), ("bfloat16", "kernel", 0.5),
    ("bfloat16", "chunked", 0.5)])
def test_caption_loss_parts_and_gradients_match_reference(monkeypatch, dtype, route, alpha):
    """The slice as a whole. ``kernel``: the port's kernel route (plain
    versions on the CPU) against the reference's Pallas kernels in interpret
    mode; ``chunked``: both on their vocab-chunk loops; ``materialised``:
    both on stored logits (fused loss off)."""
    kernel = route == "kernel"
    monkeypatch.setattr(jfl, "_INTERPRET", kernel)
    monkeypatch.setattr(fl, "KERNEL_ROUTE_ON_CPU", kernel)
    tpu = dict(use_fused_loss=route != "materialised", fused_loss_pallas=kernel)
    jm, variables, pm = build_pair(dtype, alpha, **tpu)
    batch = make_batch(seed=1)
    loss_j, parts_j, grads_j = jax_parts_and_grads(jm, variables, batch)
    loss_p, parts_p, grads_p = port_parts_and_grads(pm, batch)
    vtol, gtol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 0.12)
    np.testing.assert_allclose(parts_p, parts_j, rtol=vtol)
    np.testing.assert_allclose(loss_p, loss_j, rtol=vtol)
    assert parts_p[1] == parts_j[1] and parts_p[3] == parts_j[3]  # the counts are exact
    if alpha == 1.0:
        assert parts_p[2] == 0.0 and parts_p[3] == 0.0
    assert set(grads_p) == set(grads_j)
    for key, want in grads_j.items():
        got, want = grads_p[key].numpy().ravel(), want.numpy().ravel()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= gtol * scale + 1e-12, key
        if dtype == "bfloat16" and scale > 0:
            cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
            assert cos > 0.995, (key, cos)


def test_caption_logits_match_reference():
    jm, variables, pm = build_pair()
    feats, pad, ids, idpad, _ = make_batch(seed=2)
    logits_j, loss_j, _ = jm.apply(variables, [jnp.asarray(feats)], [jnp.asarray(pad)],
                                   jnp.asarray(ids), jnp.asarray(idpad),
                                   method=JaxMMT4Caption.caption_logits)
    with torch.no_grad():
        logits_p, loss_p, attn = pm.eval().caption_logits(
            [torch.tensor(feats)], [torch.tensor(pad)], torch.tensor(ids), torch.tensor(idpad),
            return_attn=True)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-4)
    assert attn.shape == (2, B, S - 1, T + 1)
    # no model.matching in this config: no head, and the tasks that need one
    # say so (they are held against the reference in test_torch_port_matching.py)
    assert pm.matching is None
    with pytest.raises(ValueError, match="model.matching"):
        pm.match_loss([torch.tensor(feats)], [torch.tensor(pad)], torch.zeros((B, 512)))
    with pytest.raises(ValueError, match="model.matching"):
        pm.cross_loss([torch.tensor(feats)], [torch.tensor(pad)], torch.tensor(ids),
                      torch.tensor(idpad), torch.zeros((B, 512)))


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------


def _train_config(name="adam", lr=1e-3, **kw):
    return {"task": "caption", "optimizer": {"name": name, "learning_rate": lr,
                                             "beta": [0.9, 0.999], **kw}}


@pytest.mark.parametrize("name,kw", [("adam", {}), ("adam", {"weight_decay": 0.01}),
                                     ("sgd", {"momentum": 0.9})])
def test_three_train_steps_match_reference(name, kw):
    """Three optimizer steps of both packages' train steps from the same
    weights at dropout 0: the loss of each step to 1e-4 relative, and the
    parameters after. Adam's first updates are lr * g / (|g| + eps), so where
    a gradient entry is within float32 noise of zero the two sides may step
    in different directions: atol 2 * lr there, 2e-5 for SGD."""
    from vct_tpu.config import TrainConfig as JTrainConfig
    from vct_tpu.train.optimizers import build_optimizer as j_build
    from vct_tpu.train.state import make_train_state as j_state
    from vct_tpu.train.step import make_train_step as j_step
    from vct_tpu_torch.config import TrainConfig
    from vct_tpu_torch.train.optimizers import build_optimizer
    from vct_tpu_torch.train.state import make_train_state
    from vct_tpu_torch.train.step import make_train_step

    lr = 1e-3
    jm, variables, pm = build_pair()
    batch = make_batch(seed=4)
    feats, pad, ids, idpad, valid = batch
    jopt = j_build(JTrainConfig.from_dict(_train_config(name, lr, **kw)), variables["params"])
    jstate = j_state(jax.tree_util.tree_map(jnp.asarray, variables), jopt)
    jstep = j_step(jm, jopt, "caption")
    jbatch = {"feats": [jnp.asarray(feats)], "masks": [jnp.asarray(pad)],
              "token_ids": jnp.asarray(ids), "token_mask": jnp.asarray(idpad),
              "row_valid": jnp.asarray(valid)}
    popt = build_optimizer(TrainConfig.from_dict(_train_config(name, lr, **kw)), pm)
    assert type(popt).__name__ == {"adam": "AdamW" if kw else "Adam", "sgd": "SGD"}[name]
    pstate = make_train_state(pm, popt, device=torch.device("cpu"), seed=0)
    pstep = make_train_step("caption")
    pbatch = {"feats": [torch.tensor(feats)], "masks": [torch.tensor(pad)],
              "token_ids": torch.tensor(ids), "token_mask": torch.tensor(idpad),
              "row_valid": torch.tensor(valid)}
    for i in range(3):
        jstate, jmetrics = jstep(jstate, jbatch)
        pstate, pmetrics = pstep(pstate, pbatch)
        np.testing.assert_allclose(float(pmetrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert pstate.step == 3 == int(jstate.step)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    atol = 2e-5 if name == "sgd" else 2 * lr
    moved = 0.0
    before = state_dict_from_jax({"params": variables["params"]})
    for key, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=atol, rtol=0,
                                   err_msg=key)
        moved = max(moved, float((p.detach() - before[key]).abs().max()))
        # nearly every entry agrees far inside the bound
        assert float((p.detach() - want[key]).abs().mean()) < 2e-5, key
    assert moved > 1e-4  # the steps did move the weights, far beyond the mean bound


def test_freeze_labels_and_learning_rate_helpers():
    from vct_tpu_torch.config import TrainConfig
    from vct_tpu_torch.train.optimizers import (
        build_optimizer, current_learning_rate, freeze_labels, set_learning_rate)

    _, _, pm = build_pair()
    labels = freeze_labels(pm, "caption")
    assert set(labels.values()) == {"train"}  # caption freezes only `matching`
    labels = freeze_labels(pm, "match")
    assert labels["cap_decoder.generator.weight"] == "frozen"
    assert labels["video_encoder.unify.0.weight"] == "train"
    opt = build_optimizer(TrainConfig.from_dict(dict(_train_config(), task="match")), pm)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(pm.cap_decoder.generator.weight) not in held
    assert id(pm.video_encoder.unify[0].weight) in held
    set_learning_rate(opt, 3e-5)
    assert current_learning_rate(opt) == 3e-5
    with pytest.raises(ValueError, match="unsupported optimizer"):
        build_optimizer(TrainConfig.from_dict(_train_config("lion")), pm)


@pytest.mark.parametrize("sched", [
    {"name": "CosineAnnealingLR", "T_max": 8, "eta_min": 1e-5},
    {"name": "ReduceLROnPlateau", "factor": 0.5, "patience": 1}, {"name": "none"}])
def test_schedulers_equal_the_reference(sched):
    from vct_tpu.config import TrainConfig as JTrainConfig
    from vct_tpu.train.optimizers import build_scheduler as j_build
    from vct_tpu_torch.config import TrainConfig
    from vct_tpu_torch.train.optimizers import build_scheduler

    cfg = _train_config(lr_scheduler=sched)
    a, b = build_scheduler(TrainConfig.from_dict(cfg)), j_build(JTrainConfig.from_dict(cfg))
    assert type(a).__name__ == type(b).__name__
    for metric in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7):
        args = (metric,) if sched["name"] == "ReduceLROnPlateau" else ()
        assert a.step(*args) == b.step(*args)
    assert a.state_dict() == b.state_dict()


# ---------------------------------------------------------------------------
# Trainer end to end (the synthetic workspace of tests/test_train.py)
# ---------------------------------------------------------------------------

N_VID, WT, WE = 6, 5, 16
WORDS = ["a", "person", "does", "action", "variant"] + [str(i) for i in range(8)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_trainer_ws")
    (root / "feats").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(N_VID):
        np.save(root / "feats" / f"vid{i}.npy", rng.standard_normal((WT, WE)).astype(np.float32))
        lines += [f"vid{i} a person does action {i} variant {j}" for j in range(3)]
    (root / "ann.txt").write_text("\n".join(lines))
    (root / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS))
    return root


def config_dict(root, epochs=2, val_batch=4, dropout=0.1, tag="test", save_dir="ckpt"):
    split = {"feat_dir": [str(root / "feats")], "annotation_path": str(root / "ann.txt"),
             "dataset": "msvd", "mode": "by_caption", "split_mode": "train", "batch_size": 4}
    return {
        "data": {"train": split,
                 "validation": dict(split, split_mode="validate", batch_size=val_batch),
                 "eval": dict(split, mode="by_video", split_mode="validate", batch_size=2)},
        "train": {"task": "caption",
                  "optimizer": {"name": "adam", "learning_rate": 1e-3, "beta": [0.9, 0.999],
                                "lr_scheduler": {"name": "CosineAnnealingLR", "T_max": 8,
                                                 "eta_min": 1e-5}},
                  "earlystop": 5, "epoch": epochs, "save_frequency": 100,
                  "save_dir": str(root / save_dir), "log_dir": str(root / "log"), "tag": tag,
                  "metric_earlystop": True},
        "test": {"max_length": 12},
        "model": {"modal": ["CLIP4Clip"], "modal_shape": [WE],
                  "tokenizer": "bert-base-uncased", "text_enc_type": "CLIP", "embed_dim": 32,
                  "dropout": dropout, "loss_beta": 0.5, "activation": "gelu",
                  "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                                    "mme": {"temporal": "encoding", "modal_different": True,
                                            "do_norm": False, "aggregation": "avg"}},
                  "caption_decoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                                      "sce_loss_alpha": 0.5}},
        "tpu": {"max_frames": WT, "max_caption_len": 12, "dtype": "float32", "mesh_data": 1,
                "vocab_path": str(root / "vocab.txt"), "progress_bar": False},
    }


def make_trainer(root, **kw):
    from vct_tpu_torch.train.loop import Trainer

    return Trainer(Config.from_dict(config_dict(root, **kw)), device=torch.device("cpu"),
                   log=lambda *_: None)


def params_of(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def test_trainer_fit_lowers_the_loss(workspace):
    tr = make_trainer(workspace, save_dir="ckpt_fit")
    losses = [tr.train_epoch(e) for e in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    val = tr.val_epoch()
    assert np.isfinite(val["loss"]) and val["loss"] == val["cap_loss"]
    scores = tr.fit()
    assert set(scores) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    assert (workspace / "ckpt_fit" / "test_latest.pt").is_file()


def test_val_epoch_does_not_depend_on_batching(workspace):
    """18 validation captions in batches of 4 (a last batch of 2 real rows and
    2 filler rows), 5 and 18: the same loss to float-summation order. Every
    caption here has 9 tokens, so the RCE rectangle is the same in each."""
    losses = [make_trainer(workspace, val_batch=b).val_epoch()["loss"] for b in (4, 5, 18)]
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)


def test_dropout_follows_the_generator_and_is_absent_in_eval(workspace):
    tr = make_trainer(workspace, dropout=0.3)
    from vct_tpu_torch.train.step import batch_to_arrays

    batch = batch_to_arrays(next(iter(tr.loaders["train"])), tr.device)
    args = (batch["feats"], batch["masks"], batch["token_ids"], batch["token_mask"])

    def loss(seed, train=True):
        tr.model.train(train)
        tr.state.generator.manual_seed(seed)
        with torch.no_grad():
            return float(tr.model.caption_loss(*args))

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    assert loss(1, train=False) == loss(2, train=False)
    tr.model.train()
    tr.model.set_dropout_generator(None)  # torch's default generator
    torch.manual_seed(5)
    a = float(tr.model.caption_loss(*args))
    torch.manual_seed(5)
    assert float(tr.model.caption_loss(*args)) == a


def test_dropout_keeps_the_expected_share_and_scale():
    from vct_tpu_torch.models.layers import Dropout, DropoutRng

    drop = Dropout(0.3, DropoutRng(torch.Generator().manual_seed(0)))
    x = torch.ones(200, 500)
    y = drop.train()(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert drop.eval()(x) is x and Dropout(0.0).train()(x) is x


def test_attention_dropout_acts_on_the_weights_and_returns_them_undropped():
    from vct_tpu_torch.models.layers import Dropout, DropoutRng
    from vct_tpu_torch.ops.attention import dot_product_attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 3, 8, generator=g) for _ in range(3))
    drop = Dropout(0.5, DropoutRng(torch.Generator().manual_seed(1))).train()
    out, w = dot_product_attention(q, k, v, dropout=drop, return_weights=True)
    _, w0 = dot_product_attention(q, k, v, return_weights=True)
    torch.testing.assert_close(w, w0)  # the pre-dropout weights
    keep = torch.rand(w.shape, generator=torch.Generator().manual_seed(1)) >= 0.5
    want = torch.einsum("bhqk,bkhd->bqhd", torch.where(keep, w0 * 2, 0.0), v)
    torch.testing.assert_close(out, want)


def test_checkpoint_round_trip(workspace):
    tr = make_trainer(workspace, save_dir="ckpt_rt")
    tr.train_epoch(0)
    tr.earlystop(1.5)
    path = tr.save("_roundtrip", epoch=3)
    before, step = params_of(tr), tr.state.step
    gen_before = tr.state.generator.get_state()
    tr.train_epoch(9)  # mutate weights, optimizer state and the generator
    tr.earlystop(0.5)
    tr.resume(path)
    assert tr.start_epoch == 3 and tr.state.step == step
    assert tr.earlystop.best_score == -1.5
    assert torch.equal(tr.state.generator.get_state(), gen_before)
    for k, v in params_of(tr).items():
        assert torch.equal(v, before[k]), k
    payload = torch.load(path, weights_only=True)
    assert payload["run_ctl"]["es_best_score"].dtype == torch.float64


def test_resumed_run_equals_an_uninterrupted_one(workspace):
    straight = make_trainer(workspace, epochs=3, tag="straight", save_dir="ckpt_a")
    straight.fit()
    first = make_trainer(workspace, epochs=2, tag="resumed", save_dir="ckpt_b")
    first.fit()
    second = make_trainer(workspace, epochs=3, tag="resumed", save_dir="ckpt_b")
    second.resume(str(workspace / "ckpt_b" / "resumed_latest.pt"))
    assert second.start_epoch == 2
    second.fit()
    assert second.state.step == straight.state.step
    assert second.scheduler.lr == straight.scheduler.lr
    want = params_of(straight)
    for k, v in params_of(second).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    # a finished run resumes to nothing left to train
    third = make_trainer(workspace, epochs=3, tag="resumed", save_dir="ckpt_b")
    third.resume(str(workspace / "ckpt_b" / "resumed_latest.pt"))
    assert third.start_epoch == 3 and third.fit() == {}


def test_saved_pth_loads_into_the_reference_with_the_same_loss_parts(tmp_path):
    """``save_params_only`` writes reference-keyed weights: loaded into
    ``vct_tpu`` through ``convert_state_dict`` they give the port's parts."""
    from vct_tpu.convert import load_torch_state_dict
    from vct_tpu_torch.train.state import save_params_only

    jm, variables, pm = build_pair()
    with torch.no_grad():
        for p in pm.parameters():  # move away from the shared init
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    path = tmp_path / "port.pth"
    save_params_only(str(path), pm)
    loaded, report = convert_state_dict(variables, load_torch_state_dict(str(path)))
    assert report == {"missing": [], "unexpected": []}
    batch = make_batch(seed=6)
    _, parts_j, _ = jax_parts_and_grads(jm, loaded, batch)
    _, parts_p, _ = port_parts_and_grads(pm, batch)
    np.testing.assert_allclose(parts_p, parts_j, rtol=1e-4)


def test_batch_to_arrays_marks_filler_rows(workspace):
    from vct_tpu_torch.data.collate import Batch
    from vct_tpu_torch.train.step import batch_to_arrays, combine_eval_parts

    feats = [np.zeros((4, 3, 2), np.float32)]
    masks = [np.zeros((4, 3), bool)]
    dev = torch.device("cpu")
    out = batch_to_arrays(Batch(feats, masks, ("",) * 4, ("v",) * 4, n_valid=3), dev)
    assert out["row_valid"].tolist() == [True, True, True, False] and "token_ids" not in out
    out = batch_to_arrays(Batch(feats, masks, ("",) * 4, ("v",) * 4, n_valid=None), dev)
    assert out["row_valid"].tolist() == [True] * 4
    agg = {"ce_sum": 6.0, "ce_n": 3.0, "rce_sum": 8.0, "rce_n": 4.0}
    assert combine_eval_parts("caption", agg, sce_alpha=0.5, loss_beta=0.5) == {
        "cap_loss": 2.0, "loss": 2.0}


def test_trainer_refuses_what_later_slices_port(workspace):
    from vct_tpu_torch.train.loop import Trainer

    base = config_dict(workspace)
    for patch, error, match in (
            # the match task is ported; without text-encoder assets it is
            # refused as the reference refuses it
            (lambda c: c["train"].update(task="match"), ValueError, "text_encoder"),
            (lambda c: c["tpu"].update(mesh_data=4), NotImplementedError, "DDP slice")):
        cfg = json.loads(json.dumps(base))
        patch(cfg)
        with pytest.raises(error, match=match):
            Trainer(Config.from_dict(cfg), device=torch.device("cpu"))


def test_train_cli_runs_on_the_cpu_only_when_asked(workspace, tmp_path, capsys):
    from vct_tpu_torch.cli import train as cli

    cfg = config_dict(workspace, epochs=1, tag="cli", save_dir="ckpt_cli")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    scores = cli.main(["-c", str(path), "--cpu", "--no_tensorboard", "--resume", "auto",
                       "--profile", str(tmp_path / "prof")])
    assert "CIDEr" in scores and (tmp_path / "prof" / "train_epoch.json").is_file()
    assert (workspace / "ckpt_cli" / "cli_latest.pt").is_file()
    assert "starting fresh" in capsys.readouterr().out
    # a second launch finds the finished run and trains nothing more
    assert cli.main(["-c", str(path), "--cpu", "--no_tensorboard", "--resume", "auto"]) == {}
    with pytest.raises(SystemExit, match="DDP"):
        cli.main(["-c", str(path), "--cpu", "-ws", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-c", str(path), "--no_tensorboard"])


def test_port_config_loads_the_repo_configs_like_the_reference():
    from pathlib import Path

    from vct_tpu.config import load_config as j_load
    from vct_tpu_torch.config import load_config

    for path in sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.json")):
        a, b = load_config(str(path)), j_load(str(path))
        assert dataclasses.asdict(a) == dataclasses.asdict(b), path.name
        assert isinstance(b, JaxConfig) and type(a).__name__ == "Config"
