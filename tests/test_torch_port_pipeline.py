"""The port's video -> caption path against ``vct_tpu`` on the CPU:
``pipeline.make_video_caption_fn`` (greedy, beam, attention maps), the
predict CLI on a synthetic ``.avi`` and on feature files, and the server's
``/v1/caption_video``.

Both packages get the same weights: the captioner through
``state_dict_from_jax`` (or one reference-keyed ``.pth`` that both CLIs
load), the towers through ``clip_state_dict_from_jax`` (or one OpenAI-keyed
``.npz``). Tolerance: tokens equal in float32; beam scores and attention maps
at rtol = atol = 2e-4, the reference's tower tolerance.
"""

import io
import json
import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.clip.vision import CLIPVisionTower as JaxTower
from vct_tpu.config import ModelConfig as JModelConfig
from vct_tpu.config import TPUConfig as JTPUConfig
from vct_tpu.models.mmt4caption import MMT4Caption as JaxModel
from vct_tpu.pipeline import make_video_caption_fn as j_make_fn
from vct_tpu_torch.clip.convert import clip_state_dict_from_jax
from vct_tpu_torch.clip.vision import CLIPVisionTower
from vct_tpu_torch.config import ModelConfig, TPUConfig
from vct_tpu_torch.convert import load_state_dict_into, state_dict_from_jax
from vct_tpu_torch.models.mmt4caption import MMT4Caption
from vct_tpu_torch.pipeline import make_video_caption_fn

from tests.test_pipeline import _random_openai_clip_sd, _write_video

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)
TINY_MODEL = {
    "modal": ["CLIP4Clip"], "modal_shape": [16], "embed_dim": 32, "dropout": 0.0,
    "vocab_size": 40,
    "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                      "mme": {"temporal": "encoding", "aggregation": "avg"}},
    "caption_decoder": {"layer": 1, "nhead": 2, "feedforward": 64},
}


@pytest.fixture(scope="module")
def pair():
    """The tiny captioner and tower of ``tests/test_pipeline.py`` in both
    packages, with the same weights; seeded pixels [2, 4, 224, 224, 3]."""
    rng = np.random.default_rng(0)
    n, t = 2, 4
    pixels = rng.standard_normal((n, t, 224, 224, 3)).astype(np.float32)
    jtower = JaxTower(width=64, layers=1, heads=2, out_dim=16)
    clip_params = jax.tree_util.tree_map(
        np.array, jtower.init(jax.random.PRNGKey(0), jnp.asarray(pixels[0]))["params"])
    jmodel = JaxModel(JModelConfig.from_dict(TINY_MODEL), JTPUConfig(dtype="float32"))
    caps = jnp.full((n, 8), 0, jnp.int32).at[:, 0].set(2)
    variables = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.PRNGKey(1), [jnp.zeros((n, t, 16))], [jnp.zeros((n, t), bool)], caps,
        caps == 0, method=JaxModel.caption_loss))
    model = MMT4Caption(ModelConfig.from_dict(TINY_MODEL), TPUConfig(dtype="float32"))
    report = load_state_dict_into(model, state_dict_from_jax(variables))
    assert report == {"missing": [], "unexpected": []}
    tower = CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16)
    tower.load_state_dict(clip_state_dict_from_jax(clip_params))
    return (jmodel, jtower, variables, clip_params), (model.eval(), tower.eval()), pixels


@pytest.mark.parametrize("mode", ["greedy", "beam", "attn"])
def test_video_caption_fn_matches_reference(pair, mode):
    (jmodel, jtower, variables, clip_params), (model, tower), pixels = pair
    kw = dict(max_len=8, start_id=2, end_id=3, beam_size=3 if mode == "beam" else 0,
              collect_attn=mode == "attn")
    want_tokens, want_aux = j_make_fn(jmodel, jtower, **kw)(variables, clip_params,
                                                            jnp.asarray(pixels))
    fn = make_video_caption_fn(model, tower, **kw)
    assert make_video_caption_fn(model, tower, **kw) is fn  # the closure is cached
    tokens, aux = fn(torch.tensor(pixels))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    assert (tokens[:, 0] == 2).all()
    if mode == "greedy":
        assert aux is None and want_aux is None
    else:  # beam scores [N] / attention [max_len-1, layers, N, T_mem]
        assert aux.shape == want_aux.shape
        np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)


def test_video_caption_fn_equals_tower_then_module_path(pair):
    from vct_tpu_torch.decode import greedy_generate

    _, (model, tower), pixels = pair
    px = torch.tensor(pixels)
    tokens, _ = make_video_caption_fn(model, tower, max_len=8, start_id=2, end_id=3)(px)
    with torch.no_grad():
        feats = tower(px.reshape(-1, 224, 224, 3)).reshape(2, 4, 16)
    want, _ = greedy_generate(model, [feats], [torch.zeros((2, 4), dtype=torch.bool)],
                              max_len=8, start_id=2, end_id=3)
    assert torch.equal(tokens, want)
    with pytest.raises(ValueError, match="greedy-only"):
        make_video_caption_fn(model, tower, max_len=8, start_id=2, end_id=3, beam_size=3,
                              collect_attn=True)


def test_caption_videos_matches_reference(pair, tmp_path):
    """Two .avi files through the whole batch entry of both packages: host
    sampling (uni_12), the towers, greedy decode, detokenization."""
    from vct_tpu.pipeline import caption_videos as j_caption_videos
    from vct_tpu_torch.pipeline import caption_videos
    from vct_tpu_torch.text.tokenizer import make_tokenizer

    (jmodel, jtower, variables, clip_params), (model, tower), _ = pair
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(35)]))
    tokenizer = make_tokenizer(str(tmp_path / "vocab.txt"), "bert-base-uncased")
    assert (tokenizer.start_id, tokenizer.end_id) == (2, 3)
    paths = [str(tmp_path / f"{i}.avi") for i in range(2)]
    for i, path in enumerate(paths):
        _write_video(path, n_frames=20 + 10 * i)
    got = caption_videos(paths, model=model, tower=tower, tokenizer=tokenizer, max_len=8)
    want = j_caption_videos(paths, model=jmodel, tower=jtower, variables=variables,
                            clip_params=clip_params, tokenizer=tokenizer, max_len=8)
    assert got == want and len(got) == 2
    with pytest.raises(ValueError, match="fixed frame count"):
        caption_videos(paths, model=model, tower=tower, tokenizer=tokenizer, ext_type="fix_9")


# ---------------------------------------------------------------------------
# the predict CLI of both packages, and the server's video route
# ---------------------------------------------------------------------------

WORDS = ["a", "thing", "moves", "0", "1", "2"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A tiny 512-wide captioner (config + reference-keyed .pth), a
    full-width ViT-B/32 OpenAI-keyed .npz (the CLI's tower is ViT-B/32, as the
    reference's), a synthetic .avi and a feature file."""
    from vct_tpu_torch.cli.common import make_trainer_pieces
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.train.state import save_params_only

    root = tmp_path_factory.mktemp("port_predict")
    _write_video(root / "in.avi")
    np.savez(root / "clip.npz", **_random_openai_clip_sd(np.random.default_rng(0)))
    np.save(root / "feat.npy", np.random.default_rng(1).standard_normal((5, 512)).astype(
        np.float32))
    (root / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS))
    cfg = {
        "test": {"max_length": 8},
        "model": {"modal": ["CLIP4Clip"], "modal_shape": [512], "embed_dim": 32,
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
    return root


def _both(root, *extra):
    """Run both CLIs -> ((caption, tokens, attn) of the port, of vct_tpu)."""
    from vct_tpu.cli import predict as jp
    from vct_tpu_torch.cli import predict as pp

    args = ["-c", str(root / "config.json"), "-m", str(root / "model.pth"), *extra]
    got = pp.main(args + ["--cpu", "--attn_out", str(root / "port.png")])
    got = (got, pp.predict.tokens, pp.predict.attn)
    jcap = jp.predict(jp.load_config(str(root / "config.json")), jp.build_parser().parse_args(
        args + ["--attn_out", str(root / "jax.png")]), log=lambda *_: None)
    return got, (jcap, jp.predict.tokens, jp.predict.attn)


def test_predict_cli_on_a_video_matches_reference(workspace):
    (cap, tokens, _), (jcap, jtokens, _) = _both(
        workspace, "-v", str(workspace / "in.avi"), "--ext_type", "uni_4",
        "--clip_weights", str(workspace / "clip.npz"), "--greedy")
    assert cap == jcap and isinstance(cap, str)
    np.testing.assert_array_equal(tokens, jtokens)


@pytest.mark.parametrize("mode", [[], ["--beam", "2"], ["--vis_attn"]])
def test_predict_cli_on_features_matches_reference(workspace, mode):
    (cap, tokens, attn), (jcap, jtokens, jattn) = _both(
        workspace, "-f", str(workspace / "feat.npy"), *mode)
    assert cap == jcap
    np.testing.assert_array_equal(tokens, jtokens)
    if mode == ["--vis_attn"]:
        assert attn.shape == jattn.shape == (7, 2, 1, 6)  # [max_len-1, layers, 1, T_mem]
        np.testing.assert_allclose(attn, jattn, **TOL)
        assert (workspace / "port.png").stat().st_size > 0
    else:
        assert attn is None and jattn is None


def test_predict_cli_refusals(workspace):
    from vct_tpu_torch.cli.predict import main

    base = ["-c", str(workspace / "config.json"), "-m", str(workspace / "model.pth"), "--cpu"]
    video = ["-v", str(workspace / "in.avi")]
    for extra, match in (
            (video + ["--feat_type", "I3D"], "I3D slice"),
            (video + ["--i3d_weights", "x.pt"], "I3D slice"),
            (["-f", str(workspace / "feat.npy"), "--i3d_stream", "flow"], "I3D slice"),
            (video, "--clip_weights"),
            (video + ["--beam", "2", "--vis_attn"], "requires --greedy"),
            (["-f", str(workspace / "feat.npy"), str(workspace / "feat.npy")],
             "modalities")):
        with pytest.raises(SystemExit, match=match):
            main(base + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(base[:-1] + ["-f", str(workspace / "feat.npy")])


@pytest.fixture(scope="module")
def video_server(workspace):
    from vct_tpu_torch.cli.common import load_config
    from vct_tpu_torch.serve import serve

    srv = serve(load_config(str(workspace / "config.json")), str(workspace / "model.pth"),
                device=CPU, host="127.0.0.1", port=0,
                clip_weights=str(workspace / "clip.npz"), max_batch=4,
                batch_timeout_ms=30.0, log=lambda *_: None)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.service.close()


def _post(srv, path, body):
    conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=300)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_caption_video_route_equals_tower_then_module_path(video_server, workspace):
    """Two concurrent /v1/caption_video requests answer with the port's
    module-path decode of the tower's features (uni_12 frames, subsampled to
    the config's 5); /v1/caption keeps working beside it."""
    from vct_tpu_torch.clip import preprocess_frames, sample_frames
    from vct_tpu_torch.data.collate import fit_time_axis
    from vct_tpu_torch.decode import detokenize_batch, greedy_generate

    body = (workspace / "in.avi").read_bytes()
    results = [None, None]

    def worker(i):
        results[i] = _post(video_server, "/v1/caption_video", body)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    svc = video_server.service
    feats = svc.tower_features(torch.from_numpy(
        preprocess_frames(sample_frames(str(workspace / "in.avi"), "uni_12"))))
    assert feats.shape == (12, 512) and feats.dtype == np.float32
    feat, mask = fit_time_axis(feats, 5)
    want, _ = greedy_generate(svc.model, [torch.from_numpy(feat[None])],
                              [torch.from_numpy(mask[None])], max_len=8,
                              start_id=svc.tokenizer.start_id, end_id=svc.tokenizer.end_id)
    want = detokenize_batch(svc.tokenizer, want)[0]
    assert results == [(200, {"caption": want})] * 2
    buf = io.BytesIO()
    np.save(buf, feats)
    assert _post(video_server, "/v1/caption", buf.getvalue()) == (200, {"caption": want})
    status, payload = _post(video_server, "/v1/caption_video", b"\x00\x01")
    assert status == 500 and "cannot open video" in payload["error"]
