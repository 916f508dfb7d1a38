"""Shared CLI plumbing (port of ``vct_tpu/cli/common.py``): device flags,
model construction from a config, checkpoint loading."""

from __future__ import annotations

import argparse
import dataclasses

import torch

from vct_tpu.config import Config, load_config  # noqa: F401  (re-export for CLIs)
from vct_tpu.text.tokenizer import make_tokenizer
from vct_tpu_torch.convert import load_state_dict_into, load_torch_state_dict
from vct_tpu_torch.models.mmt4caption import DTYPES, MMT4Caption


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


def load_checkpoint_into(model, path: str, log=print) -> dict:
    """Load a reference-format ``.pth`` into ``model`` (lenient, like every
    reference load site) -> the {missing, unexpected} report."""
    if not path.endswith((".pth", ".pt", ".bin")):
        raise ValueError(f"{path}: the port loads .pth/.pt/.bin state dicts")
    report = load_state_dict_into(model, load_torch_state_dict(path))
    log(f"loaded {path}: missing={len(report['missing'])} "
        f"unexpected={len(report['unexpected'])}")
    return report
