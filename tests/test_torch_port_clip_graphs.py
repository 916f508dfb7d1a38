"""The CLIP towers' compiled programs in the port, on the CPU: the padded
text encoder (``clip.text.build_text_encoder``, padded to ``BATCH_PAD``)
against ``vct_tpu``'s, the graphed vision tower
(``graphs.StagedModule(tower, "pixels")``) against the JAX tower, and the pixels-to-tokens program
(``pipeline.make_video_caption_fn``) as a ``graphs.StagedDecode`` keyed on
pixels, against the eager composition (the tower, then the eager decode
loop).

On the CPU no CUDA graph is built. The runners' capture and replay logic is
driven through the stand-in for ``graphs.capture`` of
``test_torch_port_train_graphs.py`` (``host_graphs``), whose replay re-runs
the captured function on the static inputs: what a replay of a CUDA graph
computes. Card tests: ``test_torch_port_cuda.py``.

Tolerance: ``test_torch_port_clip.py``'s (rtol = atol = 2e-4) against JAX;
the stand-in's replays against the eager runs bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.clip import text as jtext
from vct_tpu.clip import vision as jvision
from vct_tpu_torch import graphs
from vct_tpu_torch.clip import text as ptext
from vct_tpu_torch.clip.convert import clip_state_dict_from_jax
from vct_tpu_torch.clip.vision import CLIPVisionTower, init_clip_weights

from tests.test_clip_text import _make_bpe_files
from tests.test_torch_port_train_graphs import host_graphs  # noqa: F401 - a fixture

TOL = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")
CAPTIONS = ["hello world", "hello", "world hello world", "world", "hello hello world"]


# ---------------------------------------------------------------------------
# the padded text encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def text_assets(tmp_path_factory):
    """A tiny CLIP text tower (width 32, 1 layer) and its BPE files -> the
    encoder kwargs and the reference's encoder at the port's ``BATCH_PAD``."""
    from tests.test_text_encoder_integration import _tiny_clip_text_npz

    root = tmp_path_factory.mktemp("clip_text_graphs")
    vocab_json, merges_txt = _make_bpe_files(root)
    n_vocab = len(json.loads((root / "vocab.json").read_text()))
    _tiny_clip_text_npz(root / "t.npz", np.random.default_rng(0), vocab=n_vocab)
    kw = dict(clip_weights=str(root / "t.npz"), vocab_json=vocab_json, merges_txt=merges_txt)
    return kw, jtext.build_text_encoder("CLIP", batch_pad=ptext.BATCH_PAD, **kw)


@pytest.mark.parametrize("n", [3, 64, 65])
def test_padded_text_encoder_matches_reference(text_assets, n):
    kw, want_enc = text_assets
    enc = ptext.build_text_encoder("CLIP", device=CPU, **kw)
    captions = (CAPTIONS * 13)[:n]
    got = enc(captions)
    assert got.dtype == torch.float32 and got.shape == (n, 512)
    np.testing.assert_allclose(got.numpy(), want_enc(captions), **TOL)


def test_padded_text_encoder_sets(text_assets):
    """One runner set per padded shape: every batch of up to 64 captions (3,
    a short last batch, and 64) shares one, 65 take another."""
    kw, _ = text_assets
    enc = ptext.build_text_encoder("CLIP", device=CPU, **kw)
    assert ptext.BATCH_PAD == 64 and enc.runner.module is enc.tower
    for n, sets in ((3, 1), (64, 1), (65, 2), (1, 2)):
        assert enc((CAPTIONS * 13)[:n]).shape == (n, 512)
        assert enc.runner.sets == sets, n
    assert enc.runner.graphs == 0
    assert list(enc.runner._sets) == [
        graphs.shape_key({"tokens": torch.zeros((b, 77), dtype=torch.int32)})
        for b in (128, 64)]  # the last used last


# ---------------------------------------------------------------------------
# the graphed vision tower
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vision_pair():
    """The tiny tower of ``test_torch_port_pipeline.py`` (width 64, 1 layer)
    in both packages, one JAX init."""
    rng = np.random.default_rng(3)
    jtower = jvision.CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16)
    params = jax.tree_util.tree_map(np.array, jtower.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))["params"])
    tower = CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16)
    tower.load_state_dict(clip_state_dict_from_jax(params))
    apply = jax.jit(lambda px: jtower.apply({"params": params}, px))
    frames = rng.standard_normal((3, 224, 224, 3)).astype(np.float32)
    return apply, tower.eval(), frames


def test_graphed_vision_tower_matches_reference(vision_pair):
    """One set per frame count (2, 3, then 2 again); each result the JAX
    tower's, float32, and the caller's own."""
    apply, tower, frames = vision_pair
    fn = graphs.StagedModule(tower, "pixels")
    held = []
    for f, sets in ((2, 1), (3, 2), (2, 2)):
        got = fn(torch.tensor(frames[:f]))
        assert got.dtype == torch.float32 and got.shape == (f, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(apply(jnp.asarray(frames[:f]))),
                                   **TOL)
        assert fn.sets == sets and fn.graphs == 0
        held.append(got)
    torch.testing.assert_close(held[0], held[2], rtol=0, atol=0)
    assert held[0].untyped_storage().data_ptr() != held[2].untyped_storage().data_ptr()


def test_staged_module_captures_and_drops(vision_pair, host_graphs):  # noqa: F811
    """The card route through the stand-in capture, keyed on ``pixels``: the
    first call of a frame count is the eager tower, then it is captured; the
    replays give the eager bits into results of their own. Weights moved to
    new storage drop the graphs."""
    _, tower, frames = vision_pair
    tower = CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16).eval()
    tower.load_state_dict(vision_pair[1].state_dict())
    fn = graphs.StagedModule(tower, "pixels")
    px = torch.tensor(frames)
    with torch.no_grad():
        want = tower(px)
    first, again = fn(px), fn(px)
    torch.testing.assert_close(first, want, rtol=0, atol=0)
    torch.testing.assert_close(again, want, rtol=0, atol=0)
    assert first.untyped_storage().data_ptr() != again.untyped_storage().data_ptr()
    assert (fn.sets, fn.graphs, fn.replays) == (1, 1, 1)
    old = [p.data for p in tower.parameters()]  # alive: the new storage lies elsewhere
    tower.double().float()  # new parameter storage, the same modules
    fn(px)
    assert (fn.sets, fn.graphs, fn.replays, len(fn._sets)) == (2, 2, 1, 1)


def test_staged_module_keeps_the_shapes_last_used(vision_pair, host_graphs):  # noqa: F811
    """Frame counts past ``max_sets`` drop the least recently used count's
    set and graphs, so the pools a tower holds stay bounded however many
    frame counts its videos give; a dropped count seen again runs eagerly
    and is captured again, with the eager bits."""
    _, tower, frames = vision_pair
    fn = graphs.StagedModule(tower, "pixels")
    assert fn.max_sets == 4 and graphs.Staged.max_sets is None
    px = torch.tensor(frames).repeat(2, 1, 1, 1)
    for f in (1, 2, 3, 4, 1, 5, 2, 6, 1):
        got = fn(px[:f])
        with torch.no_grad():
            torch.testing.assert_close(got, tower(px[:f]), rtol=0, atol=0, msg=f"{f} frames")
        assert len(fn._sets) <= fn.max_sets and len(fn.pool_bytes) == len(fn._sets)
    assert list(fn._sets) == [graphs.shape_key({"pixels": px[:f]}) for f in (5, 2, 6, 1)]
    assert (fn.sets, fn.graphs, fn.replays) == (7, 7, 2)  # replays: 1 and 1 again


@pytest.mark.parametrize("key,x", [
    ("pixels", torch.zeros((2, 224, 224, 3))),
    ("tokens", torch.zeros((4, 77), dtype=torch.int32)),
])
def test_runner_keyed_on_other_inputs_than_feats(key, x, host_graphs):  # noqa: F811
    """A ``Staged`` runner whose inputs have no ``feats``: its device is its
    first tensor's, and its capture path runs on the stand-in."""
    assert graphs.first_tensor({key: x}) is x
    assert graphs.first_tensor({"masks": None, "feats": [x]}) is x
    assert graphs.first_tensor({"a": None, "b": [None, (x,)]}) is x
    runner = graphs.Staged([lambda st: st.update(out=st[key].float() + 1)],
                           lambda st: st["out"].clone())
    for _ in range(2):
        torch.testing.assert_close(runner.run({key: x}), x.float() + 1, rtol=0, atol=0)
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 1)


def test_on_card_reads_the_first_tensor():
    x = torch.zeros(3)
    assert not graphs.on_card({"pixels": x})
    assert not graphs.on_card({"tokens": x.int()})
    assert not graphs.on_card({"feats": [x], "masks": None})


# ---------------------------------------------------------------------------
# the pixels-to-tokens program
# ---------------------------------------------------------------------------

MAX_LEN = 20  # three 8-token stages


@pytest.fixture(scope="module")
def captioner():
    """A seeded tiny captioner (``test_torch_port_pipeline.py``'s config) and
    a seeded tiny tower, float32 on the CPU; seeded pixels of two calls."""
    from vct_tpu_torch.config import ModelConfig, TPUConfig
    from vct_tpu_torch.models.mmt4caption import MMT4Caption

    from tests.test_torch_port_pipeline import TINY_MODEL

    model = MMT4Caption(ModelConfig.from_dict(TINY_MODEL), TPUConfig(dtype="float32"))
    model.init_weights(torch.Generator().manual_seed(5))
    tower = init_clip_weights(CLIPVisionTower(width=64, layers=1, heads=2, out_dim=16),
                              torch.Generator().manual_seed(6))
    with torch.no_grad():  # no shared class and position terms, and features of unit
        tower.class_embedding.zero_()  # scale: the pixels move the tokens
        tower.positional_embedding.zero_()
        tower.proj.mul_(50.0)
    rng = np.random.default_rng(7)
    pixels = [torch.tensor(rng.standard_normal((2, 3, 224, 224, 3)).astype(np.float32))
              for _ in range(2)]
    return model.eval().to_compute_dtype(), tower.eval(), pixels


def _eager(model, tower, pixels, mode):
    """The eager composition: the tower, then the eager decode loop."""
    from vct_tpu_torch.decode import greedy_generate
    from vct_tpu_torch.decode_fast import beam_generate_fused, greedy_generate_fused

    n, t = pixels.shape[:2]
    with torch.no_grad():
        feats = [tower(pixels.reshape(n * t, 224, 224, 3)).reshape(n, t, -1)]
    masks = [torch.zeros((n, t), dtype=torch.bool)]
    kw = dict(max_len=MAX_LEN, start_id=2, end_id=-1)
    if mode == "beam":
        return beam_generate_fused(model, feats, masks, beam_size=3, **kw)
    if mode == "attn":
        return greedy_generate(model, feats, masks, collect_attn=True, **kw)
    return greedy_generate_fused(model, feats, masks, **kw)


@pytest.mark.parametrize("mode", ["greedy", "beam", "attn"])
def test_pixel_program_replays_the_eager_composition(captioner, mode, host_graphs):  # noqa: F811
    """Through the stand-in capture: the first call of a pixel shape (eager
    stages, then one graph per stage), then replays, each equal to the tower
    followed by the eager decode loop bit for bit (tokens, beam scores,
    attention maps); the results are the caller's own across calls."""
    from vct_tpu_torch.pipeline import make_video_caption_fn

    model, tower, pixels = captioner
    fn = make_video_caption_fn.__wrapped__(model, tower, max_len=MAX_LEN, start_id=2,
                                           end_id=-1, beam_size=3 if mode == "beam" else 0,
                                           collect_attn=mode == "attn")
    wants = [_eager(model, tower, px, mode) for px in pixels]
    assert not torch.equal(wants[0][0], wants[1][0])
    held = []
    for call, i in enumerate((0, 1, 0)):
        got = fn(pixels[i])
        for g, w in zip(got, wants[i]):
            assert (g is None) == (w is None)
            if w is not None:
                torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"call {call}")
        held.append(got[0])
    runner = fn.runner
    assert isinstance(runner, graphs.StagedDecode)
    assert (runner.sets, runner.graphs, runner.replays) == (1, 3, 6)  # runs free: 3 stages
    assert list(runner._sets) == [graphs.shape_key({"pixels": pixels[0]})]
    torch.testing.assert_close(held[0], held[2], rtol=0, atol=0)
    assert held[0].untyped_storage().data_ptr() != held[2].untyped_storage().data_ptr()


def test_pixel_program_on_the_host_is_one_set_per_shape(captioner):
    """Without a card the stages run on the static buffers, no graph; the
    cached program (``caption_videos``' route) keeps one set per pixel
    shape across calls."""
    from vct_tpu_torch.pipeline import make_video_caption_fn

    model, tower, pixels = captioner
    fn = make_video_caption_fn(model, tower, max_len=MAX_LEN, start_id=2, end_id=-1)
    assert make_video_caption_fn(model, tower, max_len=MAX_LEN, start_id=2, end_id=-1) is fn
    for px in (*pixels, pixels[0][:1]):
        tokens, _ = fn(px)
        torch.testing.assert_close(tokens, _eager(model, tower, px, "greedy")[0], rtol=0,
                                   atol=0)
    assert (fn.runner.sets, fn.runner.graphs, fn.runner.replays) == (2, 0, 0)


def test_service_tower_is_graphed_and_warmed_at_uni_12(captioner, host_graphs,  # noqa: F811
                                                       tmp_path, monkeypatch):
    """The server's tower is the graphed tower: its start captures the
    uni_12 frame count; another count is captured at its first request and
    replayed after."""
    from vct_tpu_torch.cli import predict as pcli
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.serve import CaptionService
    from vct_tpu_torch.train.state import save_params_only

    from tests.test_torch_port_pipeline import TINY_MODEL

    model, tower, _ = captioner
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(35)]))
    cfg = Config.from_dict({"model": TINY_MODEL, "test": {"max_length": 8},
                            "tpu": {"max_frames": 4, "dtype": "float32",
                                    "vocab_path": str(tmp_path / "vocab.txt")}})
    save_params_only(str(tmp_path / "model.pth"), model)
    monkeypatch.setattr(pcli, "load_clip_tower", lambda weights, device: tower)
    svc = CaptionService(cfg, str(tmp_path / "model.pth"), device=CPU, clip_weights="seeded",
                         max_batch=2, log=lambda *_: None)
    try:
        assert isinstance(svc.tower, graphs.StagedModule) and svc.tower.module is tower
        assert (svc.tower.sets, svc.tower.graphs, svc.tower.replays) == (1, 1, 0)
        px = torch.tensor(np.random.default_rng(8).standard_normal(
            (12, 224, 224, 3)).astype(np.float32))
        for frames, counts in ((12, (1, 1, 1)), (5, (2, 2, 1)), (5, (2, 2, 2))):
            got = svc.tower_features(px[:frames])
            with torch.no_grad():
                want = tower(px[:frames]).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert (svc.tower.sets, svc.tower.graphs, svc.tower.replays) == counts
    finally:
        svc.close()
