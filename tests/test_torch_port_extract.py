"""The port's feature-extraction CLI and the I3D arm of its predict CLI
against ``vct_tpu``'s on the CPU: ``cli.extract.main`` of both packages on
the same videos and weights, ``.npy`` by ``.npy`` (CLIP at ``uni_4``; I3D
``rgb``, ``flow`` and ``both``; a 130-frame video, two stacks, and a 1-frame
one), the skip / overwrite rules and the refusals with the reference's
messages; ``cli.predict.main -v --feat_type I3D`` (``rgb`` and ``both``)
against the reference's tokens and caption; ``_order_i3d_streams``; and the
options both CLIs list.

Tolerance: features at rtol = atol = 2e-4 (float32 towers, the CLIP towers'
bound); ``both`` equal bit for bit to the single-stream runs of the same
package; tokens and captions exactly (float32 captioner).
"""

import json

import numpy as np
import pytest
import torch

from vct_tpu.cli import extract as jx
from vct_tpu.cli import predict as jp
from vct_tpu_torch.cli import extract as px
from vct_tpu_torch.cli import predict as pp

from tests.test_i3d import _synthetic_state_dict
from tests.test_pipeline import _random_openai_clip_sd, _write_video

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)
WORDS = ["a", "thing", "moves", "0", "1", "2"]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Videos (130 frames: two RGB stacks and two of 129 flow fields; 1
    frame), seeded RGB and flow I3D weights (.npz and .pt), and the port's
    single-stream extractions of both, which several tests hold against."""
    root = tmp_path_factory.mktemp("port_extract")
    vids = root / "vids"
    vids.mkdir()
    _write_video(vids / "a.avi", n_frames=130)
    _write_video(vids / "one.avi", n_frames=1)
    rs = np.random.RandomState(7)
    np.savez(root / "rgb.npz", **_synthetic_state_dict(rs))
    torch.save({k: torch.tensor(v) for k, v in
                _synthetic_state_dict(rs, in_channels=2).items()}, root / "flow.pt")
    w = {"rgb": str(root / "rgb.npz"), "flow": str(root / "flow.pt")}
    for stream in ("rgb", "flow"):
        px.main(["--videos", str(vids), "--out", str(root / f"port_{stream}"), "--cpu",
                 "--feat_type", "I3D", "--i3d_stream", stream, "--i3d_weights", w[stream]])
    return root, vids, w


def _npy(d, name):
    return np.load(d / f"{name}.npy")


def test_clip_arm_matches_reference_and_skips(tmp_path, capsys):
    vids = tmp_path / "vids"
    vids.mkdir()
    _write_video(vids / "a.avi", n_frames=30)
    _write_video(vids / "b.avi", n_frames=50)
    np.savez(tmp_path / "clip.npz", **_random_openai_clip_sd(np.random.default_rng(0)))
    args = ["--videos", str(vids), "--ext_type", "uni_4",
            "--clip_weights", str(tmp_path / "clip.npz")]
    jx.main(args + ["--out", str(tmp_path / "jax"), "--batch_frames", "8"])
    for batch in ("8", "3"):  # one chunk; chunks of 3 + 1
        px.main(args + ["--out", str(tmp_path / batch), "--batch_frames", batch, "--cpu"])
        for name in ("a", "b"):
            got, want = _npy(tmp_path / batch, name), _npy(tmp_path / "jax", name)
            assert got.shape == want.shape == (4, 512) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, **TOL)
    capsys.readouterr()
    px.main(args + ["--out", str(tmp_path / "8"), "--cpu"])
    assert "extracted 0 videos (2 skipped)" in capsys.readouterr().out
    np.save(tmp_path / "8" / "a.npy", np.zeros((1, 512), np.float32))
    px.main(args + ["--out", str(tmp_path / "8"), "--cpu", "--overwrite"])
    assert "extracted 2 videos (0 skipped)" in capsys.readouterr().out
    np.testing.assert_allclose(_npy(tmp_path / "8", "a"), _npy(tmp_path / "jax", "a"), **TOL)


@pytest.mark.parametrize("stream", ["rgb", "flow"])
def test_i3d_stream_matches_reference(assets, stream, tmp_path):
    """Two stacks of the 130-frame video, one of the 1-frame video (looped
    for RGB, a duplicated frame's near-zero field for flow)."""
    root, vids, w = assets
    jx.main(["--videos", str(vids), "--out", str(tmp_path), "--feat_type", "I3D",
             "--i3d_stream", stream, "--i3d_weights", w[stream]])
    for name, n in (("a", 2), ("one", 1)):
        got, want = _npy(root / f"port_{stream}", name), _npy(tmp_path, name)
        assert got.shape == want.shape == (n, 1024) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)


def test_i3d_both_equals_single_stream_runs(assets, tmp_path, capsys):
    root, vids, w = assets
    both = ["--videos", str(vids), "--out", str(tmp_path / "rgb"), "--out_flow",
            str(tmp_path / "flow"), "--cpu", "--feat_type", "I3D", "--i3d_stream", "both",
            "--i3d_weights", w["rgb"], "--i3d_flow_weights", w["flow"]]
    px.main(both)
    assert "extracted 2 videos" in capsys.readouterr().out
    for stream in ("rgb", "flow"):
        for name in ("a", "one"):
            np.testing.assert_array_equal(_npy(tmp_path / stream, name),
                                          _npy(root / f"port_{stream}", name))
    px.main(both)
    assert "extracted 0 videos (2 skipped)" in capsys.readouterr().out
    # a missing sibling forces the video again, but an existing output is not
    # rewritten without --overwrite
    sentinel = np.full((1, 1024), 7.0, np.float32)
    np.save(tmp_path / "rgb" / "one.npy", sentinel)
    (tmp_path / "flow" / "one.npy").unlink()
    px.main(both)
    assert "extracted 1 videos (1 skipped)" in capsys.readouterr().out
    np.testing.assert_array_equal(_npy(tmp_path / "rgb", "one"), sentinel)
    np.testing.assert_array_equal(_npy(tmp_path / "flow", "one"),
                                  _npy(root / "port_flow", "one"))


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value)


def test_extract_refusals_equal_the_reference(assets, tmp_path):
    _, vids, w = assets
    base = ["--videos", str(vids), "--out", str(tmp_path / "x"), "--feat_type", "I3D"]
    cases = [
        (base + ["--i3d_stream", "both", "--i3d_weights", w["rgb"],
                 "--i3d_flow_weights", w["flow"]], "needs --out_flow"),
        (base + ["--i3d_stream", "both", "--out_flow", str(tmp_path / "y"),
                 "--i3d_weights", w["rgb"]], "needs --i3d_flow_weights"),
        (base + ["--i3d_stream", "flow"], "FLOW state dict"),
        (base + ["--i3d_stream", "both", "--out_flow", str(tmp_path / "y")],
         "RGB state dict"),
        (["--videos", str(tmp_path / "empty"), "--out", str(tmp_path / "x"),
          "--feat_type", "I3D", "--i3d_weights", w["rgb"]], "no videos under"),
    ]
    (tmp_path / "empty").mkdir()
    for argv, match in cases:
        want = _exit_message(jx.main, argv)
        assert match in want
        assert _exit_message(px.main, argv + ["--cpu"]) == want
    (tmp_path / "dup").mkdir()
    for name in ("v.avi", "v.mp4"):
        (tmp_path / "dup" / name).write_bytes(b"")
    want = _exit_message(jx.list_videos, str(tmp_path / "dup"))
    assert "output collision" in want
    assert _exit_message(px.list_videos, str(tmp_path / "dup")) == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            px.main(base + ["--i3d_weights", w["rgb"]])


def _option_table(parser):
    return {tuple(a.option_strings): (a.default, a.choices, a.nargs, a.required)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("cli", ["extract", "predict"])
def test_clis_list_the_reference_options(cli):
    """The same options with the same defaults and choices; the reference's
    ``--tpu`` is left out of the port (``--multi_gpu`` is accepted and, on
    these single-device CLIs, changes nothing, as in the reference)."""
    ours = _option_table({"extract": px, "predict": pp}[cli].build_parser())
    theirs = _option_table({"extract": jx, "predict": jp}[cli].build_parser())
    theirs.pop(("--tpu",))
    assert ours == theirs


# ---------------------------------------------------------------------------
# predict -v --feat_type I3D
# ---------------------------------------------------------------------------


def _captioner(root, modal):
    from vct_tpu_torch.cli.common import make_trainer_pieces
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.train.state import save_params_only

    (root / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS))
    cfg = {
        "test": {"max_length": 8},
        "model": {"modal": modal, "modal_shape": [1024] * len(modal), "embed_dim": 32,
                  "dropout": 0.1, "activation": "gelu",
                  "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                                    "mme": {"temporal": "encoding", "aggregation": "avg"}},
                  "caption_decoder": {"layer": 2, "nhead": 2, "feedforward": 64}},
        "tpu": {"max_frames": 5, "max_caption_len": 10, "dtype": "float32",
                "mesh_data": 1, "vocab_path": str(root / "vocab.txt")},
    }
    (root / "config.json").write_text(json.dumps(cfg))
    model, _ = make_trainer_pieces(Config.from_dict(cfg), CPU, seed=3)
    save_params_only(str(root / "model.pth"), model)
    return ["-c", str(root / "config.json"), "-m", str(root / "model.pth")]


@pytest.mark.parametrize("stream,modal", [("rgb", ["I3D"]),
                                          ("both", ["i3d_flow", "i3d_rgb"])])
def test_predict_i3d_matches_reference(assets, stream, modal, tmp_path):
    """``both`` with the flow slot first, so ``_order_i3d_streams`` reorders."""
    _, _, w = assets
    _write_video(tmp_path / "in.avi", n_frames=30)
    args = _captioner(tmp_path, modal) + [
        "-v", str(tmp_path / "in.avi"), "--feat_type", "I3D", "--i3d_stream", stream,
        "--greedy"]
    args += (["--i3d_weights", w["rgb"]] + (["--i3d_flow_weights", w["flow"]]
                                           if stream == "both" else []))
    got = pp.main(args + ["--cpu"])
    tokens = pp.predict.tokens
    want = jp.predict(jp.load_config(str(tmp_path / "config.json")),
                      jp.build_parser().parse_args(args), log=lambda *_: None)
    assert isinstance(got, str) and got == want
    np.testing.assert_array_equal(tokens, jp.predict.tokens)


@pytest.mark.parametrize("modal", [["rgb", "flow"], ["flow", "rgb"], ["i3d", "flow"],
                                   ["flow", "motion"], ["motion", "rgb"], ["a", "b"],
                                   ["rgb_flow", "x"], ["I3D_RGB", "I3D_FLOW"]])
@pytest.mark.parametrize("streams", [["rgb", "flow"], ["rgb"]])
def test_order_i3d_streams_equals_the_reference(modal, streams):
    ours, theirs = [], []
    got = pp._order_i3d_streams(list(streams), modal, log=ours.append)
    want = jp._order_i3d_streams(list(streams), modal, log=theirs.append)
    assert got == want and ours == theirs


def test_predict_i3d_refusals_equal_the_reference(assets, tmp_path):
    _, _, w = assets
    _write_video(tmp_path / "in.avi", n_frames=2)
    base = _captioner(tmp_path, ["i3d_rgb", "i3d_flow"]) + [
        "-v", str(tmp_path / "in.avi"), "--feat_type", "I3D"]
    for extra, match in (([], "needs --i3d_weights"),
                         (["--i3d_stream", "flow"], "needs --i3d_flow_weights"),
                         (["--i3d_stream", "both", "--i3d_weights", w["rgb"]],
                          "needs --i3d_flow_weights"),
                         (["--i3d_weights", w["rgb"]], "produce 1 modality of dim 1024")):
        ns = jp.build_parser().parse_args(base + extra)
        want = _exit_message(lambda _: jp.predict(jp.load_config(ns.config), ns,
                                                  log=lambda *_: None), None)
        assert match in want
        assert _exit_message(pp.main, base + extra + ["--cpu"]) == want
