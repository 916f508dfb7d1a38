"""Inputs made from the seed: a synthetic BERT-sized vocabulary, caption
text, CLIP4Clip-shaped feature files and annotation files in the MSVD
format, all written under one directory of the run.

Every video's features and captions are a function of (seed, video index)
alone, so the check regenerates any of them without reading the program.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

SPECIAL = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
PAD_ID, START_ID, END_ID = 0, 101, 102
FIRST_WORD = 104  # ids from here on are plain words


def vocab_words(size: int) -> List[str]:
    """BERT's special ids ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102,
    [MASK]=103), ``[unusedN]`` below 100 and the word ``w<id>`` elsewhere:
    every word is one WordPiece token, so a caption's ids are its words."""
    return [SPECIAL.get(i, f"[unused{i}]" if i < 100 else f"w{i}") for i in range(size)]


def write_vocab(path: str, size: int) -> None:
    with open(path, "w") as f:
        f.write("\n".join(vocab_words(size)) + "\n")


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *keys])


def video_features(seed: int, split: int, index: int, frames: Sequence[int],
                   dim: int) -> np.ndarray:
    """Video ``index`` of split ``split``: (T, dim) float32, T uniform in
    ``frames`` (inclusive)."""
    rng = _rng(seed, split, index)
    t = int(rng.integers(frames[0], frames[1] + 1))
    return rng.standard_normal((t, dim), dtype=np.float32)


def video_captions(seed: int, split: int, index: int, count: int, words: Sequence[int],
                   vocab: int) -> List[str]:
    """``count`` captions of video ``index``, each of ``words`` (inclusive)
    plain words."""
    rng = _rng(seed, split, index, 1)
    out = []
    for _ in range(count):
        n = int(rng.integers(words[0], words[1] + 1))
        out.append(" ".join(f"w{i}" for i in rng.integers(FIRST_WORD, vocab, n)))
    return out


def caption_ids(caption: str, max_len: int) -> List[int]:
    """[CLS] + the caption's word ids + [SEP], cut to ``max_len`` with the
    [SEP] kept last."""
    ids = [START_ID] + [int(w[1:]) for w in caption.split()] + [END_ID]
    if len(ids) > max_len:
        ids = ids[:max_len - 1] + [END_ID]
    return ids


def caption_text(ids: Sequence[int], vocab: int) -> str:
    """Greedy tokens (start token first) -> the caption a user reads: cut at
    the first [SEP] (without one, the last token is dropped), the start
    token skipped, [CLS] / [SEP] literals removed."""
    ids = [int(i) for i in ids]
    end = ids.index(END_ID) if END_ID in ids else -1
    body = ids[1:end] if end >= 0 else ids[1:-1]
    words = vocab_words(vocab)
    text = " ".join(words[i] if 0 <= i < vocab else "[UNK]" for i in body)
    return text.replace("[CLS]", "").replace("[SEP]", "").strip()


def write_split(root: str, name: str, seed: int, split: int, n_videos: int,
                frames: Sequence[int], dim: int, captions: int, words: Sequence[int],
                vocab: int) -> Tuple[str, str, Dict[str, int]]:
    """One split's ``.npy`` files and MSVD annotation file under ``root`` ->
    (feature dir, annotation path, {video id: index})."""
    feat_dir = os.path.join(root, name)
    os.makedirs(feat_dir, exist_ok=True)
    ann = os.path.join(root, f"{name}.txt")
    index = {}
    with open(ann, "w") as f:
        for i in range(n_videos):
            vid = f"vid{i:05d}"
            index[vid] = i
            np.save(os.path.join(feat_dir, vid + ".npy"),
                    video_features(seed, split, i, frames, dim))
            for cap in video_captions(seed, split, i, captions, words, vocab):
                f.write(f"{vid} {cap}\n")
    return feat_dir, ann, index


def request_body(features: np.ndarray) -> bytes:
    """One ``/v1/caption`` body: the video's features as ``.npy``."""
    buf = io.BytesIO()
    np.save(buf, features)
    return buf.getvalue()
