"""The evaluation CLI of the port against ``vct_tpu.cli.eval`` on one saved
``.pth``, in float32 on the CPU: the same predictions and the same scores,
greedy and beam; the CLI's files and flags; ``pipelined_map``.

Scores are computed by the same scorer code from the predictions, so equal
predictions give scores equal to 1e-9; the predictions themselves must be
equal strings.
"""

import json

import numpy as np
import pytest
import torch

from vct_tpu.cli import eval as jax_eval
from vct_tpu.config import Config as JaxConfig
from vct_tpu_torch.cli import eval as port_eval
from vct_tpu_torch.cli.common import make_trainer_pieces, print_scores
from vct_tpu_torch.config import Config
from vct_tpu_torch.decode import pipelined_map
from vct_tpu_torch.train.state import save_params_only

from tests.test_torch_port_train import config_dict, workspace  # noqa: F401  (fixture)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def saved(workspace, tmp_path_factory):  # noqa: F811
    """(config dict, path of a reference-keyed .pth with seeded weights)."""
    cfg_d = config_dict(workspace, dropout=0.0)
    model, _ = make_trainer_pieces(Config.from_dict(json.loads(json.dumps(cfg_d))), CPU,
                                   seed=11)
    path = tmp_path_factory.mktemp("eval_ckpt") / "seeded.pth"
    save_params_only(str(path), model)
    return cfg_d, str(path)


@pytest.mark.parametrize("beam", [0, 3])
def test_cli_eval_of_both_packages_agree_on_one_pth(saved, beam):
    cfg_d, ckpt = saved
    quiet = lambda *_: None  # noqa: E731
    want = jax_eval.evaluate(JaxConfig.from_dict(json.loads(json.dumps(cfg_d))), ckpt,
                             beam=beam, log=quiet)
    want_pred = dict(jax_eval.evaluate.predictions)
    got = port_eval.evaluate(Config.from_dict(json.loads(json.dumps(cfg_d))), ckpt,
                             beam=beam, device=CPU, log=quiet)
    assert port_eval.evaluate.predictions == want_pred
    assert len(want_pred) > 2 and any(want_pred.values())
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert set(port_eval.evaluate.per_video) == set(want_pred)


def test_beam_one_predicts_what_greedy_predicts(saved):
    cfg_d, ckpt = saved
    cfg = Config.from_dict(json.loads(json.dumps(cfg_d)))
    port_eval.evaluate(cfg, ckpt, beam=0, device=CPU, log=lambda *_: None)
    greedy = dict(port_eval.evaluate.predictions)
    port_eval.evaluate(cfg, ckpt, beam=1, device=CPU, log=lambda *_: None)
    assert port_eval.evaluate.predictions == greedy


def test_filler_rows_are_dropped_by_n_valid(saved):
    """An eval batch that does not divide the split ends in filler rows:
    every video is predicted once and no filler leaks into the result."""
    cfg_d, ckpt = saved
    cfg_d = json.loads(json.dumps(cfg_d))
    cfg_d["data"]["eval"]["batch_size"] = 4
    cfg = Config.from_dict(cfg_d)
    port_eval.evaluate(cfg, ckpt, device=CPU, log=lambda *_: None)
    preds4 = dict(port_eval.evaluate.predictions)
    cfg_d["data"]["eval"]["batch_size"] = 3
    port_eval.evaluate(Config.from_dict(cfg_d), ckpt, device=CPU, log=lambda *_: None)
    assert port_eval.evaluate.predictions == preds4


def test_main_writes_predictions_and_metrics(saved, tmp_path, capsys):
    cfg_d, ckpt = saved
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg_d))
    out, metrics = tmp_path / "pred.json", tmp_path / "metrics.json"
    scores = port_eval.main(["-c", str(cfg_path), "-m", ckpt, "--cpu", "--beam", "2",
                             "--out", str(out), "--metrics_out", str(metrics),
                             "--per_video", "--baseline", "msvd"])
    printed = capsys.readouterr().out
    assert "published msvd" in printed and "wrote predictions" in printed
    preds = json.loads(out.read_text())
    record = json.loads(metrics.read_text())
    assert preds == port_eval.evaluate.predictions
    assert record.pop("_meteor_synonyms")
    assert record == {k: float(v) for k, v in scores.items()}
    assert all(np.isfinite(v) for v in record.values())
    assert {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(record)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_eval.main(["-c", str(cfg_path), "-m", ckpt])


def test_parser_and_baseline_table_match_the_reference():
    port, ref = port_eval.build_parser(), jax_eval.build_parser()
    opts = lambda p: {a.dest: (a.default, a.type) for a in p._actions}  # noqa: E731
    port_opts, ref_opts = opts(port), opts(ref)
    for dest in ("config", "model", "beam", "out", "metrics_out", "per_video", "baseline",
                 "cpu", "gpu"):
        assert port_opts[dest] == ref_opts[dest], dest
    assert port_eval.PUBLISHED == jax_eval.PUBLISHED
    scores = {"Bleu_4": 0.5, "METEOR": 0.3, "ROUGE_L": 0.7, "CIDEr": 1.0}
    lines_p, lines_r = [], []
    assert port_eval.diff_baseline(scores, "msvd", log=lines_p.append) == \
        jax_eval.diff_baseline(scores, "msvd", log=lines_r.append)
    assert lines_p[1:5] == lines_r[1:5]


def test_print_scores_rounds_like_the_reference(capsys):
    from vct_tpu.cli.common import print_scores as jax_print_scores

    scores = {"CIDEr": 1.234567, "Bleu_4": np.float32(0.5)}
    print_scores(scores)
    got = capsys.readouterr().out
    jax_print_scores(scores)
    assert got == capsys.readouterr().out and json.loads(got)["CIDEr"] == 1.2346


def test_train_state_checkpoint_loads_for_eval(saved, workspace, tmp_path):  # noqa: F811
    """A ``.pt`` written by the Trainer scores like the bare ``.pth`` of the
    same weights."""
    from vct_tpu_torch.train.loop import Trainer

    cfg_d = json.loads(json.dumps(saved[0]))
    cfg_d["train"].update(save_dir=str(tmp_path / "ckpt"), tag="ev")
    cfg = Config.from_dict(cfg_d)
    trainer = Trainer(cfg, device=CPU, log=lambda *_: None)
    pt = trainer.save("_latest", 1)
    pth = tmp_path / "same.pth"
    save_params_only(str(pth), trainer.model)
    a = port_eval.evaluate(cfg, pt, device=CPU, log=lambda *_: None)
    preds = dict(port_eval.evaluate.predictions)
    b = port_eval.evaluate(cfg, str(pth), device=CPU, log=lambda *_: None)
    assert port_eval.evaluate.predictions == preds and a == b


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_pipelined_map_keeps_submission_order(depth):
    launched, inflight_peak = [], [0]
    fetched = []

    def launch(b):
        launched.append(b)
        inflight_peak[0] = max(inflight_peak[0], len(launched) - len(fetched))
        return torch.full((2,), b)

    for b, r in pipelined_map(launch, iter(range(7)), depth=depth):
        assert r.tolist() == [b, b]
        fetched.append(b)
    assert fetched == launched == list(range(7))
    assert inflight_peak[0] == min(depth + 1, 7)  # depth + 1 briefly in flight
    assert list(pipelined_map(launch, [], depth=depth)) == []
