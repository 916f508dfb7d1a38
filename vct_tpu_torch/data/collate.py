"""Static-shape batch assembly.

The reference pads each batch to its own max length (``dataloader.py:233-276``)
— fine for eager torch, fatal for XLA, where every new shape is a recompile.
Here every batch is a fixed rectangle:

* features: [B, max_frames, E] per modality, mask [B, max_frames] True=pad
  (the reference mask convention, ``dataloader.py:246``); videos longer than
  ``max_frames`` are uniformly subsampled via truncated linspace indices
  (the native C++ loader is bit-exact with this; note it differs from the
  extraction-time uni_N sampler in ``clip/frames.py``, which ROUNDS its
  linspace — the reference has no collate-time subsampling to match, its
  features arrive pre-sampled, ``predict_video.py:157-160``),
* captions: [B, max_caption_len] token ids + pad mask via
  ``CaptionPreprocessor``,
* short batches are padded by repeating row 0 with ``n_valid`` recording how
  many rows are real (the callers drop the padding rows after the jitted
  step), so eval never recompiles on the last partial batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def fit_time_axis(feat: np.ndarray, max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """(T, E) -> ((max_frames, E), pad mask (max_frames,) True=pad)."""
    t, e = feat.shape
    if t > max_frames:
        idx = np.linspace(0, t - 1, max_frames).astype(np.int32)
        feat = feat[idx]
        t = max_frames
    out = np.zeros((max_frames, e), dtype=np.float32)
    out[:t] = feat
    mask = np.ones((max_frames,), dtype=bool)
    mask[:t] = False
    return out, mask


@dataclass
class Batch:
    """One static-shape batch. ``feats``/``masks`` are per-modality lists."""

    feats: List[np.ndarray]  # M x [B, max_frames, E_m] float32
    masks: List[np.ndarray]  # M x [B, max_frames] bool, True=pad
    captions: Tuple[str, ...]  # raw strings (metric scoring / text encoder)
    vids: Tuple[str, ...]
    token_ids: Optional[np.ndarray] = None  # [B, S] int32
    token_mask: Optional[np.ndarray] = None  # [B, S] bool, True=pad
    # rows that are real data (rest are fill); None = every row is real
    # (an explicit 0 means NO real rows — collate never builds one)
    n_valid: Optional[int] = None


def collate(
    items: Sequence[Tuple[List[np.ndarray], str, str]],
    *,
    batch_size: int,
    max_frames: int,
    preprocessor=None,
) -> Batch:
    """items: [(per-modality feats, caption, vid)] with len <= batch_size."""
    n_valid = len(items)
    if n_valid == 0:
        raise ValueError("empty batch")
    items = list(items) + [items[0]] * (batch_size - n_valid)

    num_modal = len(items[0][0])
    feats: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    for m in range(num_modal):
        fs, ms = zip(*(fit_time_axis(it[0][m], max_frames) for it in items))
        feats.append(np.stack(fs))
        masks.append(np.stack(ms))

    captions = tuple(it[1] for it in items)
    vids = tuple(it[2] for it in items)
    token_ids = token_mask = None
    if preprocessor is not None:
        token_ids, token_mask = preprocessor(captions)
    return Batch(feats, masks, captions, vids, token_ids, token_mask, n_valid)
