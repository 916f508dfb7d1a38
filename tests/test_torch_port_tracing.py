"""The port's spans (``vct_tpu_torch.tracing``) on the CPU: the ring, the
switch, the profiler's ranges, and the spans the server, the graph runner
and the Trainer record."""

import contextlib
import io
import json
import threading
import time
from collections import Counter
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from vct_tpu_torch import graphs, tracing
from vct_tpu_torch.config import Config

E_FEAT, T = 16, 5
WORDS = ["a", "person", "does", "action", "dog", "runs"]


@pytest.fixture
def ring():
    """An empty ring, spans on, emptied again after the test."""
    tracing.clear()
    yield tracing
    tracing.clear()


def test_disabled_spans_are_one_object_and_record_nothing(ring, monkeypatch):
    monkeypatch.setattr(tracing, "enabled", False)
    a, b = tracing.span("x", call=1), tracing.span("y")
    assert a is b
    with a as opened:
        tracing.record("z", 0, 1, request=2)
    assert opened.start_ns == 0 and tracing.spans() == []


def test_span_ids_parent_and_thread(ring):
    with tracing.span("outer", call=3):
        with tracing.span("inner", call=3, stage=0) as inner:
            pass
        tracing.record("stamped", inner.start_ns, tracing.now(), request=9)
    done = threading.Event()

    def other():
        with tracing.span("elsewhere"):
            done.set()

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    by = {s.name: s for s in tracing.spans()}
    assert by["inner"].parent == "outer" and by["inner"].ids == {"call": 3, "stage": 0}
    assert by["stamped"].parent == "outer" and by["stamped"].ids == {"request": 9}
    assert by["outer"].parent is None and by["elsewhere"].parent is None
    assert by["elsewhere"].thread != by["outer"].thread
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns


def test_the_ring_keeps_the_newest_spans(ring):
    extra = 5
    for i in range(tracing.MAXLEN + extra):
        tracing.record("s", i, i + 1)
    got = tracing.spans()
    assert len(got) == tracing.MAXLEN
    assert got[0].start_ns == extra and got[-1].start_ns == tracing.MAXLEN + extra - 1


def test_spans_are_profiler_ranges_on_the_trace_clock(ring, tmp_path):
    """Under a CPU recording each span is a ``record_function`` range of its
    name; put on the trace's clock by the window range's start (the anchor
    the benchmark uses), the ring's starts agree with the ranges'. A span
    still open when the recording stops closes cleanly. (A recording's
    first range takes about a millisecond to set up, part of it between the
    anchor's host reading and its range's start: one is opened before.)"""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with record_function("warm"):
        pass
    t_on = time.perf_counter()
    window = record_function("anchor.window")
    window.__enter__()
    for i in range(5):
        with tracing.span(f"work.{i}", call=i):
            torch.ones(64).sum()
    late = tracing.span("work.late")
    late.__enter__()
    window.__exit__(None, None, None)
    prof.stop()
    late.__exit__(None, None, None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = {e["name"]: float(e["ts"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    shift = ranges["anchor.window"] - t_on * 1e6
    spans = {s.name: s for s in tracing.spans()}
    assert "work.late" in spans
    for i in range(5):
        start_us = spans[f"work.{i}"].start_ns / 1e3 + shift
        assert abs(start_us - ranges[f"work.{i}"]) < 100.0, (i, start_us, ranges[f"work.{i}"])


@pytest.fixture
def host_capture(monkeypatch):
    """The runner's card route on the host: a capture runs nothing and
    records its function, a replay runs it."""

    class Replayed:
        def __init__(self, fn, out):
            self.fn, self.out = fn, out

        def replay(self):
            self.out.clear()
            self.out.update(self.fn())

    def capture(fn, *, pool, generators=()):
        out = {}
        return Replayed(fn, out), out

    @contextlib.contextmanager
    def growth(device, into):
        into["bytes"] = 0
        yield

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "side_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "pool_growth", growth)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graphs, "on_card", lambda inputs: True)


def _staged(done_after):
    """Four stages; the one numbered ``done_after`` (from 1) sets
    ``all_done``."""
    def stage(k):
        def run(st):
            st["all_done"] = torch.tensor(k + 1 >= done_after)
            st["y"] = st["x"] + k
        return run

    return graphs.Staged([stage(k) for k in range(4)], lambda st: st["y"].clone())


def _per_call(names=("graph.stage", "graph.sync")):
    runs = [s for s in tracing.spans() if s.name == "graph.run"]
    out = []
    for r in runs:
        inner = [s for s in tracing.spans()
                 if s.ids.get("call") == r.ids["call"] and s.name in names]
        assert all(s.parent in ("graph.run", "graph.capture") for s in inner)
        out.append((r.ids["new"], Counter(s.name for s in inner)))
    return out


@pytest.mark.parametrize("route", ["host", "replay"])
@pytest.mark.parametrize("done_after, stages, syncs", [(2, 2, 2), (9, 4, 3)])
def test_runner_records_each_stage_and_each_read_of_all_done(ring, request, route,
                                                             done_after, stages, syncs):
    """A stage is a ``graph.stage`` span and each read of ``all_done``
    between two stages a ``graph.sync`` span of the call: after stage 2 of 4
    the second read stops the loop; never set, three reads. ``replay``: the
    card's route (a first call captures, later calls replay)."""
    if route == "replay":
        request.getfixturevalue("host_capture")
    runner = _staged(done_after)
    x = torch.zeros(3)
    for _ in range(3):
        runner.run({"x": x})
    calls = _per_call()
    assert len(calls) == 3
    assert [new for new, _ in calls] == [1, 0, 0]
    for new, counts in calls[1:] if route == "replay" else calls:
        assert counts == Counter({"graph.stage": stages, "graph.sync": syncs})
    if route == "replay":
        assert sum(s.name == "graph.capture" for s in tracing.spans()) == 1
    assert all(s.ids["stages"] == 4 for s in tracing.spans() if s.name == "graph.run")


MODEL = {"modal": ["CLIP4Clip"], "modal_shape": [E_FEAT], "tokenizer": "bert-base-uncased",
         "embed_dim": 32, "dropout": 0.1, "activation": "gelu",
         "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                           "mme": {"temporal": "encoding", "aggregation": "avg"}},
         "caption_decoder": {"layer": 1, "nhead": 2, "feedforward": 64}}


def _tpu(root):
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS))
    return {"max_frames": T, "dtype": "float32", "vocab_path": str(root / "vocab.txt"),
            "max_caption_len": 8, "progress_bar": False}


def test_served_requests_record_their_spans(ring, tmp_path):
    """Eight requests from four threads: each has one ``serve.request`` /
    ``parse`` / ``queue`` / ``await`` with its id, each ``queue`` names a
    ``serve.batch``, and the queue wait lies inside the handler's wait."""
    from vct_tpu_torch.cli.common import make_trainer_pieces
    from vct_tpu_torch.serve import serve

    cfg = Config.from_dict({"test": {"max_length": 8}, "model": MODEL, "tpu": _tpu(tmp_path)})
    model, _ = make_trainer_pieces(cfg, torch.device("cpu"), seed=5)
    ckpt = tmp_path / "model.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    srv = serve(cfg, str(ckpt), device=torch.device("cpu"), host="127.0.0.1", port=0,
                max_batch=4, batch_timeout_ms=20.0, log=lambda *_: None)
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    rng = np.random.default_rng(0)
    bodies = []
    for n in range(8):
        buf = io.BytesIO()
        np.save(buf, rng.standard_normal((2 + n % 3, E_FEAT)).astype(np.float32))
        bodies.append(buf.getvalue())
    status = []
    tracing.clear()  # the warm-up's spans

    def client(chunk):
        for body in chunk:
            conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
            conn.request("POST", "/v1/caption", body=body)
            resp = conn.getresponse()
            resp.read()
            status.append(resp.status)
            conn.close()

    try:
        threads = [threading.Thread(target=client, args=(bodies[i::4],)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
    assert status == [200] * 8
    spans = tracing.spans()
    parts = ("serve.request", "serve.parse", "serve.queue", "serve.await")
    by_request = {}
    for s in spans:
        if s.name in parts:
            by_request.setdefault(s.ids["request"], []).append(s)
    assert len(by_request) == 8
    batches = {s.ids["batch"]: s for s in spans if s.name == "serve.batch"}
    finished = {s.ids["batch"] for s in spans if s.name == "serve.finish"}
    for rid, got in by_request.items():
        assert sorted(s.name for s in got) == sorted(parts), rid
        one = {s.name: s for s in got}
        queue, wait, req = one["serve.queue"], one["serve.await"], one["serve.request"]
        assert queue.ids["batch"] in batches and queue.ids["batch"] in finished
        assert queue.end_ns == batches[queue.ids["batch"]].start_ns
        assert queue.end_ns - queue.start_ns <= wait.end_ns - wait.start_ns
        assert queue.start_ns <= wait.start_ns and queue.end_ns <= wait.end_ns
        assert req.start_ns <= one["serve.parse"].start_ns and wait.end_ns <= req.end_ns
        assert one["serve.parse"].parent == "serve.request" == wait.parent
    assert sum(b.ids["rows"] for b in batches.values()) == 8
    collates = [s for s in spans if s.name == "serve.collate"]
    assert {s.ids["batch"] for s in collates} == set(batches)
    assert all(s.parent == "serve.batch" for s in collates)
    runs = [s for s in spans if s.name == "graph.run"]
    assert len(runs) == len(batches) and all(s.parent == "serve.batch" for s in runs)
    detok = [s for s in spans if s.name == "decode.detokenize"]
    assert len(detok) == len(batches) and all(s.parent == "serve.finish" for s in detok)


def test_train_epoch_records_fetch_step_and_copies(ring, tmp_path):
    from vct_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    (tmp_path / "feats").mkdir()
    lines = []
    for i in range(4):
        np.save(tmp_path / "feats" / f"vid{i}.npy",
                rng.standard_normal((T, E_FEAT)).astype(np.float32))
        lines += [f"vid{i} a person does action {j}" for j in range(2)]
    (tmp_path / "ann.txt").write_text("\n".join(lines))
    cfg = {
        "data": {"train": {"feat_dir": [str(tmp_path / "feats")],
                           "annotation_path": str(tmp_path / "ann.txt"), "dataset": "msvd",
                           "mode": "by_caption", "split_mode": "train", "batch_size": 4}},
        "train": {"task": "caption", "epoch": 1, "save_dir": str(tmp_path / "ckpt"),
                  "log_dir": str(tmp_path / "log"),
                  "optimizer": {"name": "adam", "learning_rate": 1e-3}},
        "model": MODEL, "tpu": _tpu(tmp_path)}
    trainer = Trainer(Config.from_dict(cfg), device=torch.device("cpu"), log=lambda *_: None)
    tracing.clear()
    trainer.train_epoch(0)
    n = len(trainer.loaders["train"])
    names = Counter(s.name for s in tracing.spans())
    assert n > 0 and names["train.fetch"] == n + 1 and names["train.step"] == n
    assert names["data.to_device"] == n
    steps = [s for s in tracing.spans() if s.name == "graph.run"]
    assert len(steps) == n and all(s.parent == "train.step" for s in steps)
    assert all(s.ids["stages"] == 1 for s in steps)
