"""The port's caption server on the CPU: HTTP contract, micro-batching, and
captions equal to the port's own decode of the same features."""

import io
import json
import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from vct_tpu.config import load_config
from vct_tpu_torch.cli.common import load_checkpoint_into, make_trainer_pieces
from vct_tpu_torch.serve import serve

E_FEAT, E2, T = 16, 24, 5
WORDS = ["a", "person", "does", "action", "dog", "runs"]


def _config(root, modal_shape):
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS))
    cfg = {
        "test": {"max_length": 8},
        "model": {
            "modal": ["CLIP4Clip", "S3D"][:len(modal_shape)],
            "modal_shape": list(modal_shape), "tokenizer": "bert-base-uncased",
            "embed_dim": 32, "dropout": 0.1, "activation": "gelu",
            "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                              "mme": {"temporal": "encoding", "aggregation": "avg"}},
            "caption_decoder": {"layer": 2, "nhead": 2, "feedforward": 64},
        },
        "tpu": {"max_frames": T, "dtype": "float32",
                "vocab_path": str(root / "vocab.txt")},
    }
    (root / "config.json").write_text(json.dumps(cfg))
    return load_config(str(root / "config.json"))


def _start(tmp_path_factory, name, modal_shape):
    root = tmp_path_factory.mktemp(name)
    cfg = _config(root, modal_shape)
    model, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=5)
    ckpt = root / "model.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    srv = serve(cfg, str(ckpt), device=torch.device("cpu"), host="127.0.0.1", port=0,
                max_batch=4, batch_timeout_ms=30.0, log=lambda *_: None)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = _start(tmp_path_factory, "port_srv", (E_FEAT,))
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.service.close()


@pytest.fixture(scope="module")
def mm_server(tmp_path_factory):
    srv = _start(tmp_path_factory, "port_mm_srv", (E_FEAT, E2))
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.service.close()


def _post(srv, path, body):
    conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_healthz(server):
    conn = HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    assert resp.status == 200 and payload["status"] == "ok"
    assert payload["device"] == "cpu"


def test_checkpoint_loaded_with_nothing_missing(tmp_path):
    cfg = _config(tmp_path, (E_FEAT,))
    a, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=1)
    b, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=2)
    torch.save(a.state_dict(), tmp_path / "a.pth")
    logs = []
    report = load_checkpoint_into(b, str(tmp_path / "a.pth"), log=logs.append)
    assert report == {"missing": [], "unexpected": []}
    assert "missing=0 unexpected=0" in logs[0]
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_npy_caption_matches_the_ports_decode(server):
    """The served caption is the port's greedy decode of the same features
    (fewer frames than max_frames, so the memory mask is used)."""
    from vct_tpu.data.collate import fit_time_axis
    from vct_tpu_torch.decode import detokenize_batch, greedy_generate

    arr = np.random.default_rng(0).standard_normal((T - 2, E_FEAT)).astype(np.float32)
    status, payload = _post(server, "/v1/caption", _npy(arr))
    assert status == 200 and isinstance(payload["caption"], str)
    svc = server.service
    feat, mask = fit_time_axis(arr, T)
    tokens, _ = greedy_generate(svc.model, [torch.from_numpy(feat[None])],
                                [torch.from_numpy(mask[None])], max_len=8,
                                start_id=svc.tokenizer.start_id,
                                end_id=svc.tokenizer.end_id)
    assert payload["caption"] == detokenize_batch(svc.tokenizer, tokens)[0]


def test_npz_caption_and_transposed_features(server):
    rng = np.random.default_rng(1)
    status, payload = _post(server, "/v1/caption",
                            _npz(CLIP4Clip=rng.standard_normal((T, E_FEAT)).astype(np.float32)))
    assert status == 200 and isinstance(payload["caption"], str)
    status, payload = _post(server, "/v1/caption",
                            _npy(rng.standard_normal((E_FEAT, 3)).astype(np.float32)))
    assert status == 200


def test_concurrent_requests_share_batches(server):
    rng = np.random.default_rng(2)
    bodies = [_npy(rng.standard_normal((T, E_FEAT)).astype(np.float32)) for _ in range(6)]
    before = dict(server.service.stats)
    results = [None] * 6

    def worker(i):
        results[i] = _post(server, "/v1/caption", bodies[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 for r in results)
    assert server.service.stats["requests"] - before["requests"] == 6
    assert server.service.stats["batches"] - before["batches"] < 6


def test_bad_requests(server):
    status, payload = _post(server, "/v1/caption", b"not an npy file")
    assert status in (400, 500) and "error" in payload
    status, payload = _post(server, "/v1/caption", _npy(np.zeros((T, E_FEAT + 1), np.float32)))
    assert status == 400 and "feature dim" in payload["error"]
    status, _ = _post(server, "/v1/nope", b"")
    assert status == 404
    # no --clip_weights: the reference's refusal (the route itself is held in
    # test_torch_port_pipeline.py)
    status, payload = _post(server, "/v1/caption_video", b"\x00\x01")
    assert status == 400 and "server started without --clip_weights" in payload["error"]


def test_multimodal_npz(mm_server):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((T, E_FEAT)).astype(np.float32)
    b = rng.standard_normal((T, E2)).astype(np.float32)
    status, payload = _post(mm_server, "/v1/caption", _npz(CLIP4Clip=a, S3D=b))
    assert status == 200 and isinstance(payload["caption"], str)
    status, payload = _post(mm_server, "/v1/caption", _npz(modal_0=a, modal_1=b.T))
    assert status == 200
    status, payload = _post(mm_server, "/v1/caption", _npz(CLIP4Clip=a))
    assert status == 400 and "missing modality" in payload["error"]
