"""Cells at a size the CPU holds, for the benchmark's own tests."""

from __future__ import annotations

import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib.cells import load_cell  # noqa: E402

TINY_MODEL = {"embed_dim": 64, "modal_shape": [32]}
TINY_TRAFFIC = {
    "serve-poisson": {"rate_per_s": 40.0, "threads": 8, "warm_requests": 8,
                      "check_requests": 12, "trace_start_s": 0.2, "trace_seconds": 0.5},
    "train-clips": {"videos": 24, "captions_per_video": 4, "trace_start_s": 0.1,
                    "trace_seconds": 0.3},
    "eval-beam4": {"videos": 20, "check_videos": 6, "trace_start_s": 0.1, "trace_seconds": 0.3},
}


def tiny_cell(name: str):
    """Cell ``name`` with the model cut to toy widths (64-wide, 2 heads,
    one decoder layer, a 512-word vocab), short captions and frames, and a
    small share of its traffic."""
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY_MODEL)
    for part in ("video_encoder", "caption_decoder"):
        cfg["model"][part].update(nhead=2, feedforward=128)
    cfg["model"]["caption_decoder"]["layer"] = 1
    cfg["vocab_size"] = 512
    cfg["tpu"]["max_frames"] = min(cfg["tpu"]["max_frames"], 16)
    cfg["tpu"]["max_caption_len"] = min(cfg["tpu"]["max_caption_len"], 24)
    cfg["test"]["max_length"] = 12
    for split in cfg["data"].values():
        split["batch_size"] = 8
    cell.config = cfg
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.workload["traffic"]]}
    return cell
