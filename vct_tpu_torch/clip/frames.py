"""Video decode + frame sampling, the host side of the video->caption path
(a copy of ``vct_tpu/clip/frames.py``; numpy and OpenCV only).

``--ext_type`` follows the reference's ``[type]_[param]`` contract
(``predict_video.py:159-160``):

* ``uni_N``  - N frames uniformly spaced over the whole video (the mode the
  shipped checkpoints were trained with: CLIP4CLIP-ViT-B-32 + uni_12),
* ``fps_N``  - sample at N frames per second,
* ``fix_N``  - every N-th frame (fixed stride),
* ``tsn_N``  - TSN-style: split into N equal segments, take each segment's
  center frame.

Decode is OpenCV on the host; the card sees only the stacked frames after
``vct_tpu_torch.clip.vision.preprocess_frames``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def parse_ext_type(ext_type: str) -> Tuple[str, float]:
    """'uni_12' -> ('uni', 12.0). Validates the [type]_[param] format."""
    try:
        kind, param = ext_type.rsplit("_", 1)
        value = float(param)
    except ValueError as e:
        raise ValueError(
            f"ext_type must look like 'uni_12'/'fps_2'/'fix_20'/'tsn_12', got {ext_type!r}"
        ) from e
    if kind not in ("uni", "fps", "fix", "tsn"):
        raise ValueError(f"unknown ext_type kind {kind!r} in {ext_type!r}")
    if value <= 0:
        raise ValueError(f"ext_type param must be positive, got {ext_type!r}")
    return kind, value


def frame_indices(n_frames: int, fps: float, ext_type: str) -> np.ndarray:
    """Which frame indices to keep for a video of ``n_frames`` at ``fps``."""
    kind, param = parse_ext_type(ext_type)
    if n_frames <= 0:
        raise ValueError("video has no frames")
    if kind == "uni":
        n = max(1, int(param))
        return np.linspace(0, n_frames - 1, n).round().astype(np.int64)
    if kind == "fps":
        step = fps / param
        if step <= 0:
            raise ValueError(f"bad fps {fps} for ext_type {ext_type!r}")
        idx = np.arange(0, n_frames, step).round().astype(np.int64)
        return np.clip(idx, 0, n_frames - 1)
    if kind == "fix":
        return np.arange(0, n_frames, max(1, int(param)), dtype=np.int64)
    # tsn: N segments, center frame of each
    n = max(1, int(param))
    edges = np.linspace(0, n_frames, n + 1)
    return ((edges[:-1] + edges[1:]) / 2).astype(np.int64).clip(0, n_frames - 1)


def _scan_sampled(cap, idx) -> list:
    """Sequentially decode up to max(idx) and keep the sampled frames (with
    multiplicity) — cheaper + more reliable than CAP_PROP_POS_FRAMES seeks.
    Returns fewer than len(idx) frames when the stream ends early."""
    import cv2

    count: dict = {}
    for w in idx.tolist():
        count[w] = count.get(w, 0) + 1
    frames: list = []
    i, last = 0, int(idx.max())
    while i <= last:
        ok, frame = cap.read()
        if not ok:
            break
        if i in count:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.extend([rgb] * count[i])
        i += 1
    return frames


def sample_frames(video_path: str, ext_type: str = "uni_12") -> np.ndarray:
    """Decode ``video_path`` and return sampled uint8 RGB frames [T, H, W, 3]."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path!r}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n_frames > 0:
            wanted = frame_indices(n_frames, fps, ext_type)
            frames = _scan_sampled(cap, wanted)
            if len(frames) == len(wanted):
                return np.stack(frames)
            # CAP_PROP_FRAME_COUNT over-reported (common with VFR mp4) and the
            # scan came up short; fall through to the two-pass path so the
            # sampler sees the TRUE frame count and still returns exactly N.
            cap.release()
            cap = cv2.VideoCapture(video_path)
        # unknown/unreliable frame count: two passes, O(sampled) memory —
        # buffering every decoded RGB frame of a long/high-res video before
        # sampling can run to tens of GB. Pass 1 counts (decode + discard),
        # pass 2 keeps only the sampled indices.
        true_count = 0
        while True:
            ok, _ = cap.read()
            if not ok:
                break
            true_count += 1
        if true_count == 0:
            raise RuntimeError(f"decoded 0 frames from {video_path!r}")
        idx = frame_indices(true_count, fps, ext_type)
        cap.release()
        cap = cv2.VideoCapture(video_path)
        frames = _scan_sampled(cap, idx)
        if len(frames) != len(idx):  # second decode shorter than the first
            raise RuntimeError(
                f"inconsistent decode of {video_path!r}: pass 1 saw "
                f"{true_count} frames, pass 2 came up short"
            )
        return np.stack(frames)
    finally:
        cap.release()
