"""Micro-batching caption server (port of ``vct_tpu/serve.py``).

A worker thread drains a request queue up to ``max_batch`` (or
``batch_timeout_ms``), pads the batch to ``max_batch`` rows and runs one
decode on the device — greedy (on CUDA, one ``fused_whole_step`` launch per
token for ``max_batch`` <= 64) or, with ``tpu.beam_size`` > 1, beam search on
the decode kernels. One decode stays in flight: the next group is
launched before the previous group's tokens are copied back.

Endpoints (stdlib ``http.server``; JSON out):
  GET  /healthz            -> {"status": "ok", ...}
  POST /v1/caption         body = one video's features: ``.npy`` (T, E) for
                           single-modality models, or ``.npz`` with one
                           (T, E_m) array per modality (keys = the config's
                           modal names, or ``modal_0``, ``modal_1``, ...)
                           -> {"caption": ...}
  POST /v1/caption_video   body = raw video bytes (OpenCV-decodable)
                           -> {"caption": ...} (needs --clip_weights; models
                           of one CLIP modality only, the one the tower
                           makes): frames are sampled on the host (uni_12),
                           the CLIP ViT-B/32 tower runs on the server's
                           device, its features join the batcher's queue

Run: ``python -m vct_tpu_torch.serve -c config.json -m ckpt.pth --port 8000
[--clip_weights ViT-B-32.pt]``
"""

from __future__ import annotations

import io
import json
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch


class ServerOverloadedError(RuntimeError):
    """The request queue is full — the caller should retry later (503)."""


class _Request:
    __slots__ = ("feats", "event", "caption", "error", "abandoned")

    def __init__(self, feats: List[np.ndarray]):
        self.feats = feats  # per-modality (T, E_m) float32, already oriented
        self.event = threading.Event()
        self.caption: Optional[str] = None
        self.error: Optional[str] = None
        self.abandoned = False


class CaptionService:
    """Micro-batching captioner with a thread-safe ``caption_features`` and
    one background batcher thread that owns the device work."""

    def __init__(self, cfg, ckpt_path: str, *, device: torch.device,
                 clip_weights: Optional[str] = None,
                 max_batch: int = 32, batch_timeout_ms: float = 5.0,
                 max_queue: Optional[int] = None,
                 max_body_bytes: int = 64 * 1024 * 1024, log=print):
        from vct_tpu_torch.cli.common import load_checkpoint_into, make_trainer_pieces
        from vct_tpu_torch.decode import make_auto_beam_fn, make_auto_greedy_fn

        self.cfg, self.log, self.device = cfg, log, torch.device(device)
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.model, self.tokenizer = make_trainer_pieces(cfg, self.device)
        load_checkpoint_into(self.model, ckpt_path, log=log)
        self.model.to_compute_dtype()
        # tpu.beam_size > 1 serves beam search, the same dispatch the
        # Trainer's epoch eval uses
        if cfg.tpu.beam_size > 1:
            self.decode_fn = make_auto_beam_fn(
                self.model, cfg.test.max_length, self.tokenizer.start_id,
                self.tokenizer.end_id, cfg.tpu.beam_size)
        else:
            self.decode_fn = make_auto_greedy_fn(
                self.model, cfg.test.max_length, self.tokenizer.start_id,
                self.tokenizer.end_id)

        # build the kernels and warm the decode now, so /healthz is truthful
        # and the first requests do not pay for it
        warm_f = [torch.zeros((max_batch, cfg.tpu.max_frames, e), device=self.device)
                  for e in cfg.model.modal_shape]
        warm_m = [torch.zeros((max_batch, cfg.tpu.max_frames), dtype=torch.bool,
                              device=self.device) for _ in cfg.model.modal_shape]
        self.decode_fn(warm_f, warm_m)[0].cpu()

        self.tower = None
        if clip_weights:
            from vct_tpu_torch.cli.predict import load_clip_tower

            self.tower = load_clip_tower(clip_weights, self.device)
            # warm the tower at the default ext_type's frame count (uni_12)
            self.tower_features(torch.zeros((12, 224, 224, 3)))

        self.max_queue = max_queue if max_queue is not None else 8 * max_batch
        self.max_body_bytes = max_body_bytes
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=self.max_queue)
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "rejected": 0}
        self._stats_lock = threading.Lock()  # 'rejected' moves on handler threads
        self._worker = threading.Thread(target=self._batch_loop, daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def _orient(self, feats: np.ndarray, e: int, what: str) -> np.ndarray:
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 3 and feats.shape[0] == 1:
            feats = feats[0]
        if feats.ndim != 2:
            raise ValueError(f"{what}: expected 2-D features, got {feats.shape}")
        if feats.shape[0] == 0:
            raise ValueError(f"{what}: features contain no frames")
        # orient by the model dim: long videos may legitimately have T > E
        if feats.shape[1] != e and feats.shape[0] == e:
            feats = feats.T
        if feats.shape[1] != e:
            raise ValueError(f"{what}: feature dim {feats.shape[1]} != model dim {e}")
        return feats

    def caption_features(self, feats, timeout: float = 60.0) -> str:
        """One video's features -> caption; blocks until served."""
        shapes = self.cfg.model.modal_shape
        if not isinstance(feats, (list, tuple)):
            feats = [feats]
        if len(feats) != len(shapes):
            raise ValueError(f"model expects {len(shapes)} modalities, got {len(feats)}")
        feats = [self._orient(f, e, f"modality {i}")
                 for i, (f, e) in enumerate(zip(feats, shapes))]
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        req = _Request(feats)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.stats["rejected"] += 1
            raise ServerOverloadedError(
                f"request queue full ({self.max_queue} deep); retry later") from None
        if not req.event.wait(timeout):
            req.abandoned = True
            raise TimeoutError("caption request timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.caption

    @torch.no_grad()
    def tower_features(self, pixels: torch.Tensor) -> np.ndarray:
        """CLIP-normalized frames [T, 224, 224, 3] -> features [T, 512]
        float32, by the tower on the server's device."""
        return self.tower(pixels.to(self.device)).float().cpu().numpy()

    def caption_video(self, video_bytes: bytes, ext_type: str = "uni_12",
                      timeout: float = 120.0) -> str:
        if self.tower is None:
            raise ValueError("server started without --clip_weights; "
                             "send features to /v1/caption instead")
        from vct_tpu_torch.clip import preprocess_frames, sample_frames

        if len(self.cfg.model.modal_shape) != 1:
            raise ValueError("/v1/caption_video serves single-CLIP-modality "
                             "models; send per-modality features to /v1/caption")
        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(video_bytes)
            f.flush()
            frames = sample_frames(f.name, ext_type)
        feats = self.tower_features(torch.from_numpy(preprocess_frames(frames)))
        return self.caption_features(feats, timeout=timeout)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        while True:  # fail anything still queued instead of letting it time out
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            r.error = "server shutting down"
            r.event.set()

    # -- batcher ------------------------------------------------------------

    def _finish(self, batch: List[_Request], tokens: torch.Tensor, n: int) -> None:
        """Copy a launched decode back and answer its requests; asynchronous
        device errors surface here."""
        from vct_tpu_torch.decode import detokenize_batch

        try:
            captions = detokenize_batch(self.tokenizer, tokens)[:n]
            for r, c in zip(batch, captions):
                r.caption = c
            self.stats["requests"] += n
            self.stats["batches"] += 1
        except Exception as e:  # noqa: BLE001 - reported per request
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
        finally:
            for r in batch:
                r.event.set()

    def _launch(self, batch: List[_Request]):
        from vct_tpu_torch.data.collate import fit_time_axis

        max_t = self.cfg.tpu.max_frames
        pad = self.max_batch - len(batch)
        feats_l, masks_l = [], []
        for m in range(len(self.cfg.model.modal_shape)):
            fs, ms = zip(*(fit_time_axis(r.feats[m], max_t) for r in batch))
            feats_l.append(torch.from_numpy(np.stack(fs + (fs[0],) * pad)).to(self.device))
            masks_l.append(torch.from_numpy(np.stack(ms + (ms[0],) * pad)).to(self.device))
        tokens, _ = self.decode_fn(feats_l, masks_l)
        return tokens

    def _batch_loop(self):
        inflight = None
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.001 if inflight else 0.1)
            except queue.Empty:
                if inflight is not None:
                    self._finish(*inflight)
                    inflight = None
                continue
            batch: List[_Request] = [first]
            deadline = time.monotonic() + self.batch_timeout
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            batch = [r for r in batch if not r.abandoned]
            if not batch:
                continue
            try:
                tokens = self._launch(batch)
            except Exception as e:  # noqa: BLE001 - reported per request
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.event.set()
                if inflight is not None:
                    self._finish(*inflight)
                    inflight = None
                continue
            if inflight is not None:
                self._finish(*inflight)
            inflight = (batch, tokens, len(batch))
        if inflight is not None:
            self._finish(*inflight)


def make_handler(service: CaptionService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "device": str(service.device),
                                  "queued": service._queue.qsize(), **service.stats})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = -1
            if length < 0:
                self._reply(400, {"error": "bad Content-Length"})
                self.close_connection = True
                return
            if length > service.max_body_bytes:
                # reject before reading: the body never enters RAM
                self._reply(413, {"error": f"body {length} bytes exceeds limit "
                                           f"{service.max_body_bytes}"})
                self.close_connection = True
                return
            body = self.rfile.read(length)
            try:
                if self.path.startswith("/v1/caption_video"):
                    caption = service.caption_video(body)
                elif self.path.startswith("/v1/caption"):
                    loaded = np.load(io.BytesIO(body), allow_pickle=False)
                    if hasattr(loaded, "files"):  # .npz: one array per modality
                        feats = []
                        for i, name in enumerate(service.cfg.model.modal):
                            key = name if name in loaded.files else f"modal_{i}"
                            if key not in loaded.files:
                                raise ValueError(f"npz missing modality {name!r} "
                                                 f"(keys: {loaded.files})")
                            feats.append(loaded[key])
                    else:
                        feats = loaded
                    caption = service.caption_features(feats)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                self._reply(200, {"caption": caption})
            except ServerOverloadedError as e:
                self._reply(503, {"error": str(e), "retry": True})
            except TimeoutError as e:
                self._reply(503, {"error": str(e)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    request_queue_size = 128  # accept a burst, shed with 503 instead of resets
    daemon_threads = True


def serve(cfg, ckpt_path: str, *, device: torch.device, host="0.0.0.0",
          port=8000, clip_weights=None, max_batch=32, batch_timeout_ms=5.0,
          max_queue=None, max_body_bytes=64 * 1024 * 1024, log=print):
    service = CaptionService(cfg, ckpt_path, device=device, clip_weights=clip_weights,
                             max_batch=max_batch, batch_timeout_ms=batch_timeout_ms,
                             max_queue=max_queue, max_body_bytes=max_body_bytes, log=log)
    server = _Server((host, port), make_handler(service))
    server.service = service
    return server


def main(argv=None) -> None:
    import argparse

    from vct_tpu_torch.cli.common import add_device_args, load_config, resolve_device

    p = argparse.ArgumentParser(description="Batching caption server (PyTorch/CUDA)")
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("-m", "--model", required=True, type=str,
                   help="reference-format .pth state dict")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--clip_weights", type=str, default=None,
                   help="CLIP ViT-B/32 weights (OpenAI .pt / HF .bin / .npz) for "
                        "/v1/caption_video")
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--batch_timeout_ms", type=float, default=5.0)
    p.add_argument("--max_queue", type=int, default=None,
                   help="queued requests before 503 (default 8*max_batch)")
    p.add_argument("--max_body_mb", type=int, default=64,
                   help="request body cap in MiB before 413")
    add_device_args(p)
    args = p.parse_args(argv)

    server = serve(load_config(args.config), args.model, device=resolve_device(args),
                   host=args.host, port=args.port, clip_weights=args.clip_weights,
                   max_batch=args.max_batch, batch_timeout_ms=args.batch_timeout_ms,
                   max_queue=args.max_queue,
                   max_body_bytes=args.max_body_mb * 1024 * 1024)
    print(f"serving on {args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, device={server.service.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.service.close()


if __name__ == "__main__":
    main()
