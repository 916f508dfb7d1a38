"""The LFM2 caption LM (``vct_tpu_torch/models/lfm2.py``) on the CPU at toy
widths, against the plain float32 reference beside these tests
(``tests/lfm2_reference.py``, which imports nothing of the port): its config
section, logits, SCE loss and gradients, left padding, the greedy decode
through its two-state cache, the grouped expert path against a per-expert
loop, the router with and without its expert bias, a ``cli.train`` epoch with
validation and the eval decode, and the routes that refuse it.

Everything here runs in float32 on the plain versions of the kernels (CPU
tensors), so the port and the reference part by summation order alone (1e-5
on losses, 1e-4 of the largest gradient).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests import lfm2_reference as ref
from vct_tpu_torch.config import Config
from vct_tpu_torch.models.lfm2 import caption_lm_config
from vct_tpu_torch.models.mmt4caption import MMT4Caption
from vct_tpu_torch.ops import moe_kernels as mk

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
V = 64
PAD, CLS, SEP = 0, 2, 3
FEAT, FRAMES, CAP = 16, 6, 10
LAYER_TYPES = ["conv", "conv", "full_attention", "conv", "conv", "conv", "full_attention"]
LM = {"model_type": "lfm2_moe", "hidden_size": 32, "intermediate_size": 48,
      "moe_intermediate_size": 16, "num_hidden_layers": 6, "layer_types": LAYER_TYPES,
      "num_attention_heads": 4, "num_key_value_heads": 2, "num_dense_layers": 2,
      "num_experts": 6, "num_experts_per_tok": 2, "conv_L_cache": 3, "conv_bias": False,
      "norm_eps": 1e-5, "rope_theta": 1e6, "norm_topk_prob": True,
      "routed_scaling_factor": 1.0, "use_expert_bias": True, "vocab_size": V,
      "max_position_embeddings": 256}


def raw_config(root=None, epochs=1):
    split = {"feat_dir": [str(root / "feats") if root else ""],
             "annotation_path": str(root / "ann.txt") if root else "", "dataset": "msvd",
             "mode": "by_caption", "split_mode": "train", "batch_size": 4}
    return {
        **{k: v for k, v in LM.items() if k != "vocab_size"}, "vocab_size": V,
        "data": {"train": split, "validation": dict(split, split_mode="validate"),
                 "eval": dict(split, mode="by_video", split_mode="validate", batch_size=2)},
        "train": {"task": "caption",
                  "optimizer": {"name": "adam", "learning_rate": 1e-3, "beta": [0.9, 0.999]},
                  "earlystop": 5, "epoch": epochs, "save_frequency": 100,
                  "save_dir": str(root / "ckpt") if root else "ckpt",
                  "log_dir": str(root / "log") if root else "log", "tag": "lfm2",
                  "metric_earlystop": True},
        "test": {"max_length": 8},
        "model": {"modal": ["CLIP4Clip"], "modal_shape": [FEAT], "tokenizer": "bert-base-uncased",
                  "text_enc_type": "CLIP", "embed_dim": 24, "dropout": 0.0, "loss_beta": 0.5,
                  "activation": "gelu",
                  "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 40,
                                    "mme": {"temporal": "encoding", "modal_different": True,
                                            "do_norm": False, "aggregation": "avg"}},
                  "caption_decoder": {"layer": 1, "nhead": 2, "feedforward": 40,
                                      "sce_loss_alpha": 0.5},
                  "caption_lm": {}},
        "tpu": {"max_frames": FRAMES, "max_caption_len": CAP, "dtype": "float32",
                "mesh_data": 1, "vocab_path": str(root / "vocab.txt") if root else "",
                "progress_bar": False},
    }


def dims():
    return {"embed_dim": 24, "encoder_layers": 1, "encoder_heads": 2, "hidden": 32, "heads": 4,
            "kv_heads": 2, "head_dim": 8, "kinds": LAYER_TYPES[:6], "dense_layers": 2,
            "experts": 6, "top_k": 2, "moe_width": 16, "eps": 1e-5, "theta": 1e6,
            "norm_topk_prob": True, "scaling": 1.0, "use_expert_bias": True, "pad_id": PAD,
            "sce_alpha": 0.5}


def model(seed=0, raw=None):
    raw = raw or raw_config()
    cfg = Config.from_dict(raw)
    m = MMT4Caption(dataclasses.replace(cfg.model, vocab_size=V, pad_id=PAD), cfg.tpu,
                    caption_lm=caption_lm_config(raw))
    m.init_weights(torch.Generator().manual_seed(seed))
    return m


def batch(seed=0, b=5):
    """Features with 2..6 real frames of 6 slots (pad True), captions of 1-7
    words ([CLS] ... [SEP], pads after)."""
    rng = np.random.default_rng(seed)
    x = torch.zeros((b, FRAMES, FEAT))
    pad = torch.ones((b, FRAMES), dtype=torch.bool)
    ids = torch.zeros((b, CAP), dtype=torch.long)
    for r in range(b):
        t = int(rng.integers(2, FRAMES + 1))
        x[r, :t] = torch.as_tensor(rng.standard_normal((t, FEAT)), dtype=torch.float32)
        pad[r, :t] = False
        n = int(rng.integers(1, 8))
        ids[r, 0], ids[r, n + 1] = CLS, SEP
        ids[r, 1:n + 1] = torch.as_tensor(rng.integers(5, V, n))
    return x, pad, ids


def weights_of(m):
    return {k: v.detach().clone().requires_grad_(v.is_floating_point())
            for k, v in m.state_dict().items()}


def choice_of(m, t):
    return [layer.last_idx[t].long() for layer in m.cap_decoder.moe_layers()]


def test_config_section_switches_the_lm_on_and_the_keys_sit_at_the_top_level():
    raw = raw_config()
    top = caption_lm_config(raw)
    assert top.hidden_size == 32 and top.kinds == tuple(LAYER_TYPES[:6]) and top.head_dim == 8
    assert caption_lm_config({"model": {}}) is None
    with pytest.raises(ValueError, match="empty object"):
        caption_lm_config({**raw, "model": {"caption_lm": {"num_experts": 8}}})
    with pytest.raises(ValueError, match="not at the top level"):
        caption_lm_config({"model": {"caption_lm": {}}, **{k: LM[k] for k in list(LM)[1:]}})
    with pytest.raises(ValueError, match="model_type"):
        caption_lm_config({**raw, "model_type": "lfm2"})
    with pytest.raises(ValueError, match="tokenizer"):
        model(raw={**raw, "vocab_size": V - 1})


def test_logits_loss_and_gradients_match_the_reference():
    m = model()
    x, pad, ids = batch()
    loss = m.caption_loss([x], [pad], ids, ids == PAD)
    loss.backward()
    t = x.shape[0] * (1 + FRAMES + CAP - 1)
    choice = choice_of(m, t)
    w = weights_of(m)
    rec = []
    want = ref.caption_loss(w, dims(), x, pad, ids, ref.Precision(), choice, rec)
    want.backward()
    assert abs(float(loss) - float(want)) < 1e-5
    for name, p in m.named_parameters():
        if p.grad is not None and name in w:
            g = w[name].grad
            assert (p.grad - g).abs().max() <= 1e-4 * max(1.0, float(g.abs().max())), name
    assert w["cap_decoder.layers.2.feed_forward.experts.w13"].grad.abs().sum() > 0
    # the reference's own choice is the program's at every real position
    mem_pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
    real = ref.real_positions(mem_pad, ids[:, :-1], PAD)
    for c, (own, _) in zip(choice, rec):
        assert torch.equal(c.sort(dim=1).values[real], own.sort(dim=1).values[real])
    with torch.no_grad():
        logits, _, _ = m.caption_logits([x], [pad], ids, ids == PAD)
        memory, mp = ref.encode(w, dims(), x, pad, ref.Precision())
        ref_logits = ref.logits_of(w, ref.lm_hidden(w, dims(), memory, mp, ids[:, :-1],
                                                    ref.Precision(), choice), ref.Precision())
    assert (logits - ref_logits).abs().max() < 1e-4


def test_left_padding_gives_each_row_its_unpadded_logits():
    """A video in 6 frame slots of which 3 are real gives the caption the
    logits it has when the slots hold its 3 frames alone."""
    m = model(seed=1).eval()
    x, pad, ids = batch(seed=1)
    r = int((~pad).sum(dim=1).argmin())
    n = int((~pad[r]).sum())
    with torch.no_grad():
        padded, _, _ = m.caption_logits([x[r:r + 1]], [pad[r:r + 1]], ids[r:r + 1],
                                        ids[r:r + 1] == PAD)
        alone, _, _ = m.caption_logits([x[r:r + 1, :n]], [pad[r:r + 1, :n]], ids[r:r + 1],
                                       ids[r:r + 1] == PAD)
    assert n < FRAMES and (padded - alone).abs().max() < 1e-4


def test_prefill_then_decode_matches_the_full_forward():
    """The greedy decode's logits at every step, through the cache of
    convolution inputs and attention keys and values, against the
    teacher-forced forward over the tokens it chose."""
    m = model(seed=2).eval()
    x, pad, _ = batch(seed=2)
    lm = m.cap_decoder
    steps = 7
    with torch.no_grad():
        memory, mem_mask, _ = m.encode([x], [pad])
        start = torch.full((x.shape[0],), CLS, dtype=torch.long)
        logits, cache = lm.prefill(memory, mem_mask, start, steps + 1)
        tokens, got = [start], [logits]
        for _ in range(steps - 1):
            tokens.append(logits.argmax(dim=-1))
            logits, cache = lm.decode_step(tokens[-1], cache)
            got.append(logits)
        want = lm.logits(lm.hidden(memory, torch.stack(tokens, dim=1), mem_mask))
    assert (torch.stack(got, dim=1) - want).abs().max() < 1e-4
    for layer, state in zip(lm.layers, cache["states"]):
        if layer.kind == "conv":
            assert state.shape == (x.shape[0], 3, 32)
        else:
            assert state["k"].shape == (x.shape[0], 2, 1 + FRAMES + steps + 1, 8)


def test_greedy_decode_follows_the_module_rules():
    from vct_tpu_torch.decode import make_auto_greedy_fn

    from vct_tpu_torch import tracing

    m = model(seed=3).eval()
    x, pad, _ = batch(seed=3)
    tracing.clear()
    tokens, attn = make_auto_greedy_fn(m, 8, CLS, SEP)([x], [pad])
    names = [sp.name for sp in tracing.spans()]
    assert names.count("lm.prefill") == 1 and names.count("lm.decode") == 1
    assert names.count("moe.layer") >= 4
    assert attn is None and tokens.shape == (5, 8) and tokens.dtype == torch.int32
    assert bool((tokens[:, 0] == CLS).all())
    with torch.no_grad():
        memory, mem_mask, _ = m.encode([x], [pad])
        logits = m.cap_decoder.logits(m.cap_decoder.hidden(memory, tokens[:, :-1].long(),
                                                            mem_mask))
    done = torch.zeros(5, dtype=torch.bool)
    for i in range(7):
        if bool(done.all()):
            assert bool((tokens[:, i + 1] == PAD).all())
            continue
        assert torch.equal(tokens[:, i + 1].long(), logits[:, i].argmax(dim=-1))
        done |= tokens[:, i + 1] == SEP


def _naive_experts(x, w13, w2, idx):
    """Each pick's expert output in the picks' own order [T, k, H], one
    expert at a time."""
    inter = w2.shape[2]
    out = torch.zeros(idx.shape + (x.shape[1],))
    for e in range(w13.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        h = x[tok] @ w13[e].t()
        act = torch.nn.functional.silu(h[:, :inter]) * h[:, inter:]
        out = out.index_put((tok, slot), act @ w2[e].t())
    return out


def test_grouped_path_matches_a_per_expert_loop():
    g = torch.Generator().manual_seed(4)
    t, e, k, h, inter = 37, 6, 2, 32, 16
    logits = torch.randn((t, e), generator=g)
    route = mk.moe_route(logits, torch.zeros(e), k)
    x = torch.randn((t, h), generator=g, requires_grad=True)
    w13 = (torch.randn((e, 2 * inter, h), generator=g) * 0.2).requires_grad_(True)
    w2 = (torch.randn((e, h, inter), generator=g) * 0.2).requires_grad_(True)
    gy = torch.randn((t, k, h), generator=g)
    y = mk.experts(x, w13, w2, route, torch.float32)
    got = y.index_select(0, route.dest.reshape(-1).long()).view(t, k, h)
    grads = torch.autograd.grad(got, (x, w13, w2), gy)
    want = _naive_experts(x, w13, w2, route.idx.long())
    want_grads = torch.autograd.grad(want, (x, w13, w2), gy)
    assert (got - want).abs().max() < 1e-5
    for a, b in zip(grads, want_grads):
        assert (a - b).abs().max() < 1e-5 * max(1.0, float(b.abs().max()))
    assert route.offsets.tolist()[-1] == t * k
    rows = route.src.long()
    experts_of_rows = torch.repeat_interleave(torch.arange(e), route.counts.long())
    assert torch.equal(route.idx.long()[rows].eq(experts_of_rows[:, None]).any(dim=1),
                       torch.ones(t * k, dtype=torch.bool))


def test_router_choice_with_and_without_the_expert_bias():
    """Top k of sigmoid(logits) + bias, ties to the lower expert; the same
    logits with a bias that lifts expert 5 put it in every token's set, and
    ``use_expert_bias`` false leaves the bias out."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((40, 6), generator=g)
    plain = mk.moe_route(logits, torch.zeros(6), 2)
    s = torch.sigmoid(logits)
    assert torch.equal(plain.idx.long(), s.topk(2, dim=1).indices)
    lifted = mk.moe_route(logits, torch.tensor([0, 0, 0, 0, 0, 2.0]), 2)
    assert bool((lifted.idx == 5).any(dim=1).all())
    assert torch.equal(mk.moe_route(torch.zeros((3, 6)), torch.zeros(6), 2).idx,
                       torch.tensor([[0, 1]] * 3, dtype=torch.int32))
    raw = raw_config()
    m = model(raw=raw)
    moe = m.cap_decoder.moe_layers()[0]
    moe.expert_bias.fill_(0.0)
    moe.expert_bias[5] = 2.0
    x = torch.randn((9, 32), generator=g)
    with torch.no_grad():
        moe(x, torch.float32)
        assert bool((moe.last_idx[9] == 5).any(dim=1).all())
        moe.use_bias = False
        moe(x, torch.float32)
        own = mk.moe_route(torch.nn.functional.linear(x, moe.gate.weight), torch.zeros(6), 2)
        assert torch.equal(moe.last_idx[9], own.idx)
    assert int(moe.rows_per_expert.sum()) == 9 * 2


def _workspace(root):
    (root / "feats").mkdir()
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(V - len(SPECIALS))]
    lines = []
    for i in range(8):
        np.save(root / "feats" / f"vid{i}.npy",
                rng.standard_normal((int(rng.integers(2, 9)), FEAT)).astype(np.float32))
        lines += [f"vid{i} " + " ".join(rng.choice(words, int(rng.integers(2, 7))))
                  for _ in range(2)]
    (root / "ann.txt").write_text("\n".join(lines))
    (root / "vocab.txt").write_text("\n".join(SPECIALS + words))


def test_cli_train_runs_an_epoch_with_validation_and_the_eval_decode(tmp_path):
    from vct_tpu_torch.cli import train as cli

    _workspace(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw_config(tmp_path, epochs=1)))
    trainer, scores = cli.run(cli.build_parser().parse_args(
        ["-c", str(path), "--cpu", "--no_tensorboard"]))
    assert trainer.model.caption_lm is not None and len(trainer.history) == 1
    epoch = trainer.history[0]
    assert np.isfinite(epoch["train_loss"]) and np.isfinite(epoch["val"]["loss"])
    assert len(trainer.last_captions) == 8 and "CIDEr" in scores
    assert all(m.last_idx for m in trainer.model.cap_decoder.moe_layers())


def test_serving_beam_and_the_fused_routes_refuse_the_lm(tmp_path):
    from vct_tpu_torch.decode import make_auto_beam_fn, make_beam_fn
    from vct_tpu_torch.decode_fast import make_fused_beam_fn, make_fused_greedy_fn
    from vct_tpu_torch.decode import make_auto_greedy_fn
    from vct_tpu_torch.serve import CaptionService

    m = model().eval()
    for make in (lambda: make_auto_beam_fn(m, 8, CLS, SEP, 4),
                 lambda: make_beam_fn(m, 8, CLS, SEP, 4),
                 lambda: make_fused_beam_fn(m, 8, CLS, SEP, 4),
                 lambda: make_fused_greedy_fn(m, 8, CLS, SEP)):
        with pytest.raises(ValueError, match="model.caption_lm"):
            make()
    x, pad, _ = batch()
    with pytest.raises(ValueError, match="attention maps"):
        make_auto_greedy_fn(m, 8, CLS, SEP, collect_attn=True)([x], [pad])
    _workspace(tmp_path)
    cfg = Config.from_dict(raw_config(tmp_path))
    with pytest.raises(ValueError, match="model.caption_lm"):
        CaptionService(cfg, str(tmp_path / "none.pth"), device=torch.device("cpu"))
