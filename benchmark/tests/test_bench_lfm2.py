"""The LFM2 cell at a size the CPU holds: its configuration and weights
against the program's model, its plain reference against the port, and runs
of its driver, sound and with the timed path broken underneath.

    python3 -m pytest benchmark/tests/test_bench_lfm2.py -q
"""

from __future__ import annotations

import copy
import dataclasses
import filecmp
import os
import time

import numpy as np
import pytest
import torch

from tiny import BENCH, ROOT

import run  # noqa: E402
from benchlib import data, lfm2  # noqa: E402
from benchlib.cells import load_cell  # noqa: E402
from reference import checks as ref_checks  # noqa: E402
from reference import lfm2 as ref  # noqa: E402

SEED = 2 ** 31 + 1913
TINY_LM = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
           "num_attention_heads": 4, "num_key_value_heads": 2, "num_experts": 8,
           "num_experts_per_tok": 2, "vocab_size": 512}


def tiny_lfm2_cell():
    """``lfm2-moe-train`` at toy widths (the layer pattern, routing rules and
    traffic's shapes as published, cut in width and count), a small share of
    its traffic, in float32: the limits are set for bf16 at the published
    widths on the card, and these runs test what the check catches."""
    cell = load_cell("lfm2-moe-train")
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(embed_dim=48, modal_shape=[32])
    cfg["model"]["video_encoder"].update(nhead=2, feedforward=64)
    cfg.update(TINY_LM)
    cfg["tpu"]["max_frames"] = 6
    cfg["tpu"]["max_caption_len"] = 10
    cfg["test"]["max_length"] = 8
    cfg["tpu"]["dtype"] = "float32"
    for split in cfg["data"].values():
        split["batch_size"] = 6
    cell.config = cfg
    cell.traffic = {**cell.traffic, "videos": 16, "captions_per_video": 3, "frames": [2, 9],
                    "words": [2, 7], "ring_batches": 8, "trace_start_s": 0.1,
                    "trace_seconds": 0.3}
    return cell


@pytest.fixture(scope="module")
def cell():
    return tiny_lfm2_cell()


@pytest.fixture(scope="module")
def dims(cell):
    return lfm2.dims_of(cell.config)


def port_model(cell, dims):
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.convert import load_state_dict_into
    from vct_tpu_torch.models.lfm2 import caption_lm_config
    from vct_tpu_torch.models.mmt4caption import MMT4Caption

    cfg = Config.from_dict(cell.config)
    model = MMT4Caption(dataclasses.replace(cfg.model, vocab_size=dims["vocab"]), cfg.tpu,
                        caption_lm=caption_lm_config(cell.config))
    report = load_state_dict_into(model, lfm2.make_weights(dims, SEED, "cpu"))
    assert report == {"missing": [], "unexpected": []}
    return model


def inputs(dims, n=5):
    feats = [data.video_features(SEED, 3, i, (2, 9), dims["feat_dim"]) for i in range(n)]
    x, pad = ref_checks.fitted(feats, dims["max_frames"], "cpu")
    ids = np.zeros((n, dims["max_caption_len"]), dtype=np.int64)
    for r, c in enumerate(data.video_captions(SEED, 3, 0, n, (1, 12), dims["vocab"])):
        c = data.caption_ids(c, dims["max_caption_len"])
        ids[r, :len(c)] = c
    return x, pad, torch.as_tensor(ids)


def test_the_two_copies_of_the_reference_are_one():
    assert filecmp.cmp(os.path.join(BENCH, "reference", "lfm2.py"),
                       os.path.join(ROOT, "tests", "lfm2_reference.py"), shallow=False)


def test_published_sizes_and_parameters():
    d = lfm2.dims_of(load_cell("lfm2-moe-train").config)
    assert (d["hidden"], d["heads"], d["kv_heads"], d["head_dim"]) == (2048, 32, 8, 64)
    assert (d["dense_width"], d["moe_width"], d["experts"], d["top_k"]) == (7168, 1792, 32, 4)
    assert d["kinds"] == ["conv", "conv", "full_attention", "conv", "conv", "conv"]
    assert d["vocab"] == 65536 and d["dense_layers"] == 2
    h, v = 2048, 65536
    conv = 3 * h * h + 3 * h + h * h + 2 * h
    attn = 2 * h * h + 2 * h * 512 + 2 * 64 + 2 * h
    dense = 3 * h * 7168
    moe = 32 * h + 32 * 3 * h * 1792
    encoder = 768 * 512 + 768 + 4 * 768 * 768 + 4 * 768 + 2 * 768 * 2048 + 2048 + 768 + 6 * 768
    total = (encoder + 768 * h + h + v * h + 2 * (conv + dense) + attn + moe + 3 * (conv + moe)
             + h + 512 * 768 + 512)
    assert lfm2.parameters(d) == total


def test_expert_launch_counts_by_hand():
    d = lfm2.dims_of(load_cell("lfm2-moe-train").config)
    per = lfm2.expert_launches(d, 64)
    r = 64 * 44 * 4
    assert per[0][0]["flops"] == 2.0 * r * 3584 * 2048
    assert per[2][1]["bytes"] == r * (3584 + 2048) * 2 + 32 * 3584 * 2048 * 4
    routed = sum(c["flops"] for mode in per.values() for c in mode)
    assert routed == 3 * 3 * 2.0 * r * 2048 * 1792


def test_weights_cover_the_program(cell, dims):
    port_model(cell, dims)


def test_reference_matches_the_port(cell, dims):
    """float32 on the CPU: the loss and every gradient, the reference given
    the program's experts; its own choice is the same set."""
    model = port_model(cell, dims).train()
    x, pad, ids = inputs(dims)
    got = model.caption_loss([x], [pad], ids, ids == 0)
    got.backward()
    moes = model.cap_decoder.moe_layers()
    t = x.shape[0] * lfm2.positions(dims, 1)[1]
    choice = [m.last_idx[t].long() for m in moes]
    w = {k: v.requires_grad_(True) for k, v in lfm2.make_weights(dims, SEED, "cpu").items()}
    rec = []
    want = ref.caption_loss(w, dims, x, pad, ids, ref.Precision(), choice, rec)
    want.backward()
    assert abs(float(got) - float(want)) < 1e-5
    for name, p in model.named_parameters():
        if p.grad is not None:
            g = w[name].grad
            assert (p.grad - g).abs().max() <= 1e-4 * max(1.0, float(g.abs().max())), name
    mem_pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
    real = ref.real_positions(mem_pad, ids[:, :-1], 0)
    for c, (own, _) in zip(choice, rec):
        assert torch.equal(c.sort(dim=1).values[real], own.sort(dim=1).values[real])


def drive(monkeypatch=None, with_ctx=False):
    ctx, out, result = run.run_cell(tiny_lfm2_cell(), seed=SEED, seconds=1.0, trace=False,
                                    device=torch.device("cpu"), t_process=time.perf_counter())
    return (ctx, out, result) if with_ctx else (out, result)


def failing(result):
    return sorted(k for k, c in result["checks"].items() if c["value"] > c["limit"])


def test_a_sound_run_is_correct():
    torch.set_num_threads(4)
    _, result = drive()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "later_loss_gap", "grad_gap", "grad_error",
                                     "change_gap", "route_mismatch"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_experts_left_out_of_the_router_are_caught(monkeypatch):
    """A router that never picks the last expert: its tokens' sets differ
    from the reference's."""
    from vct_tpu_torch.ops import moe_kernels

    real = moe_kernels.moe_route

    def route(logits, bias, k):
        return real(logits.masked_fill(torch.arange(logits.shape[1]) == logits.shape[1] - 1,
                                       -1e4), bias, k)

    monkeypatch.setattr(moe_kernels, "moe_route", route)
    _, result = drive()
    assert not result["correct"] and "route_mismatch" in failing(result)


def test_an_expert_bias_left_out_is_caught(monkeypatch):
    from vct_tpu_torch.ops import moe_kernels

    real = moe_kernels.moe_route
    monkeypatch.setattr(moe_kernels, "moe_route",
                        lambda logits, bias, k: real(logits, torch.zeros_like(bias), k))
    _, result = drive()
    assert not result["correct"] and "route_mismatch" in failing(result)


def test_a_train_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
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
    _, result = drive()
    assert not result["correct"] and "change_gap" in failing(result)


def test_the_control_and_the_faults_are_read_as_controls_py_reads_them():
    """The fp8 control, with its own experts, fails a limit; so do half of
    each batch left out, a step that leaves its state unchanged and routing
    that drops the expert bias."""
    from benchlib.cells import driver

    ctx, out, result = drive(with_ctx=True)
    drv = driver(ctx.cell)
    limits = ctx.cell.limits
    control = drv.judge_control(ctx, out)
    assert any(control[k] > limits[k] for k in limits), control
    assert control["route_parted"] > 0
    faults = drv.judge_faults(ctx, out)
    assert faults["state_unchanged"]["change_gap"] > limits["change_gap"]
    assert any(v > limits[k] for k, v in faults["half_batch"].items())
    dropped = faults["expert_bias_dropped"]
    assert dropped["route_mismatch"] > limits["route_mismatch"]
    assert 0 < control["route_counted_share"] <= 1 and 0 < dropped["route_counted_share"] <= 1
