"""Video -> caption inference: CLIP frame encoding + the captioner (port of
``vct_tpu/pipeline.py``).

The reference runs this as three systems: an ``ExtractCLIP`` subprocess for
features (``predict_video.py:34-38``), then the captioner's encoder, then a
host-looped greedy decode. Here, as in the JAX package's one XLA program, the
CLIP tower runs inside the decode program: ``make_video_caption_fn`` puts it
in front of the prologue of the decode that ``make_auto_greedy_fn`` /
``make_auto_beam_fn`` pick (the decode kernels on the card, their plain
versions on CPU tensors; the module path when attention maps are collected),
so one ``graphs.StagedDecode`` takes pixels to tokens, on the card as CUDA
graphs captured once per pixel shape. Nothing goes back to the host between
the tower and the decoder.

Host work stays host work: video decode and frame sampling
(``vct_tpu_torch.clip.frames``) and detokenization.
"""

from __future__ import annotations

import functools
from typing import Callable, List

import numpy as np
import torch

from vct_tpu_torch.clip.vision import CLIPVisionTower, preprocess_frames
from vct_tpu_torch.decode import make_auto_beam_fn, make_auto_greedy_fn
from vct_tpu_torch.graphs import StagedDecode


# lru_cache keyed on the modules (hashed by identity): repeated
# caption_videos calls reuse the same program, so its graphs are captured
# once per pixel shape, as the reference's jax.jit cache hits, and the decode
# extracts the kernel weights once, at its first call. Load the checkpoint
# first.
@functools.lru_cache(maxsize=8)
def make_video_caption_fn(model, tower: CLIPVisionTower, *, max_len: int = 30,
                          start_id: int = 101, end_id: int = 102,
                          collect_attn: bool = False, beam_size: int = 0) -> Callable:
    """-> fn(pixels [N, T, 224, 224, 3] on the model's device) -> (tokens
    [N, max_len], attn or None); ``beam_size > 1`` runs beam search instead
    of greedy (the second return is then the per-video beam score; attention
    collection is greedy-only). One program from pixels to tokens: the
    tower, then the decode's prologue and stages, as a ``graphs.StagedDecode``
    keyed on the pixels' shape (``fn.runner``), with the eager composition's
    bits (the tower, then the eager decode loop). A model whose weights
    tensor parallelism split decodes eagerly, and ``fn`` has no runner."""
    if beam_size > 1 and collect_attn:
        raise ValueError("collect_attn is greedy-only; drop beam_size")
    if beam_size > 1:
        decode = make_auto_beam_fn(model, max_len, start_id, end_id, beam_size)
    else:
        decode = make_auto_greedy_fn(model, max_len, start_id, end_id,
                                     collect_attn=collect_attn)

    def features(pixels: torch.Tensor):
        n, t = pixels.shape[:2]
        feats = tower(pixels.reshape((n * t,) + pixels.shape[2:]))
        feats = feats.reshape(n, t, feats.shape[-1]).float()
        return [feats], [torch.zeros((n, t), dtype=torch.bool, device=feats.device)]

    if not isinstance(decode, StagedDecode):
        @torch.no_grad()
        def eager(pixels: torch.Tensor):
            return decode(*features(pixels))

        return eager

    def front(st):
        st["feats"], st["masks"] = features(st["pixels"])

    program = decode.fronted(front)

    @torch.no_grad()
    def fn(pixels: torch.Tensor):
        return program.run({"pixels": pixels})

    fn.runner = program
    return fn


def caption_videos(video_paths: List[str], *, model, tower: CLIPVisionTower, tokenizer,
                   ext_type: str = "uni_12", max_len: int = 30) -> List[str]:
    """End-to-end batch: decode and sample frames on the host, one tower and
    decode pass on the tower's device, detokenize. All videos must yield the
    same frame count (uni_N / tsn_N do)."""
    from vct_tpu_torch.clip.frames import sample_frames
    from vct_tpu_torch.decode import detokenize_batch

    pixel_batches = [preprocess_frames(sample_frames(p, ext_type)) for p in video_paths]
    t = pixel_batches[0].shape[0]
    if any(pb.shape[0] != t for pb in pixel_batches):
        raise ValueError(
            f"a batch needs a fixed frame count; use uni_N/tsn_N (got "
            f"{[pb.shape[0] for pb in pixel_batches]})")
    device = next(tower.parameters()).device
    pixels = torch.from_numpy(np.stack(pixel_batches)).to(device)
    fn = make_video_caption_fn(model, tower, max_len=max_len, start_id=tokenizer.start_id,
                               end_id=tokenizer.end_id)
    tokens, _ = fn(pixels)
    return detokenize_batch(tokenizer, tokens)
