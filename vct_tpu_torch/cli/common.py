"""Shared CLI plumbing (port of ``vct_tpu/cli/common.py``): device flags,
model construction from a config, checkpoint loading."""

from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from typing import Dict, List

import numpy as np
import torch

from vct_tpu_torch import config as _config
from vct_tpu_torch.config import Config
from vct_tpu_torch.text.tokenizer import make_tokenizer
from vct_tpu_torch.convert import load_state_dict_into, load_torch_state_dict
from vct_tpu_torch.models.mmt4caption import DTYPES, MMT4Caption


# Fields of the reference's ``tpu`` section that the port reads nowhere: each
# tunes a TPU-side schedule the port leaves out (``vct_tpu/decode.py:283``,
# ``vct_tpu/models/mmt4caption.py:71,114``).
IGNORED_TPU_OPTIONS = ("fast_numerics", "fused_loss_stash", "pallas_partition_kernels")


def ignored_options(cfg: Config) -> List[str]:
    """The ``tpu.*`` options that ``cfg`` turns on and the port ignores."""
    return [f"tpu.{name}" for name in IGNORED_TPU_OPTIONS if getattr(cfg.tpu, name)]


def load_config(path: str) -> Config:
    """The config at ``path`` (reference JSONs load verbatim), with one
    warning that names the options it turns on which the port ignores."""
    cfg = _config.load_config(path)
    ignored = ignored_options(cfg)
    if ignored:
        warnings.warn(f"{path}: {', '.join(ignored)} set to true; the PyTorch port ignores "
                      f"{'it' if len(ignored) == 1 else 'them'}", UserWarning, stacklevel=2)
    return cfg


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """Reference device flags (``--cpu``/``--gpu``). ``--gpu`` (the default)
    means the first CUDA device and fails when there is none: nothing moves to
    the CPU unless ``--cpu`` asks for it."""
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--cpu", action="store_true", help="run on the host CPU")
    group.add_argument("--gpu", action="store_true", help="run on cuda:0 (default)")


def resolve_device(args: argparse.Namespace) -> torch.device:
    if getattr(args, "cpu", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to run on the host")
    return torch.device("cuda", 0)


def make_trainer_pieces(cfg: Config, device: torch.device, *, seed=None):
    """(model, tokenizer) for inference: ``vocab_size`` and ``pad_id`` come
    from the tokenizer (as the reference takes [PAD] from it); weights are
    drawn from ``seed`` (default ``cfg.tpu.seed``) in float32, ready for a
    checkpoint load and then ``to_compute_dtype``."""
    tokenizer = make_tokenizer(cfg.tpu.vocab_path, cfg.model.tokenizer)
    model_cfg = cfg.model
    if (model_cfg.vocab_size != tokenizer.vocab_size
            or model_cfg.pad_id != tokenizer.pad_id):
        model_cfg = dataclasses.replace(model_cfg, vocab_size=tokenizer.vocab_size,
                                        pad_id=tokenizer.pad_id)
    model = MMT4Caption(model_cfg, cfg.tpu, dtype=DTYPES[cfg.tpu.dtype], device=device)
    gen = torch.Generator().manual_seed(cfg.tpu.seed if seed is None else seed)
    model.init_weights(gen).eval()
    return model, tokenizer


def memory_mask_advisory(cfg: Config) -> str:
    """One-line parity note for reference ``.pth`` loads: this decoder masks
    padded memory slots by default, the reference never does — observable
    only when videos are shorter than ``tpu.max_frames``. Empty when the
    quirk flag already matches."""
    if cfg is None or cfg.tpu.quirk_no_memory_mask_in_decoder:
        return ""
    return (
        "note: decoder cross-attention masks padded memory slots (a fix over "
        "the reference); for bit-parity evals with this .pth on videos "
        "shorter than max_frames set tpu.quirk_no_memory_mask_in_decoder=true"
    )


def load_checkpoint_into(model, path: str, log=print, cfg: Config = None) -> dict:
    """Load a reference-format ``.pth`` state dict, or the model weights of a
    train-state ``.pt`` checkpoint, into ``model`` (lenient, like every
    reference load site) -> the {missing, unexpected} report."""
    if not path.endswith((".pth", ".pt", ".bin")):
        raise ValueError(f"{path}: the port loads .pth/.pt/.bin state dicts")
    report = load_state_dict_into(model, load_torch_state_dict(path))
    log(f"loaded {path}: missing={len(report['missing'])} "
        f"unexpected={len(report['unexpected'])}")
    advisory = memory_mask_advisory(cfg)
    if advisory:
        log(advisory)
    return report


def load_feature_files(paths: List[str]) -> List[np.ndarray]:
    """``--features a.npy b.npy`` -> per-modality [1, T, E] arrays (reference
    ``predict_video.py:115-116``; (E, T) arrays are transposed like
    ``dataloader.py:382-385``)."""
    feats = []
    for p in paths:
        a = np.load(p).astype(np.float32)
        if a.ndim != 2:
            raise ValueError(f"{p}: expected 2-D (T, E) features, got {a.shape}")
        if a.shape[0] > a.shape[1]:  # stored (E, T) -> (T, E)
            a = a.T
        feats.append(a[None])
    return feats


def print_scores(scores: Dict[str, float]) -> None:
    print(json.dumps({k: round(float(v), 4) for k, v in scores.items()}, indent=2))
