"""Train state and checkpoints (port of ``vct_tpu/train/state.py``).

A checkpoint is the complete training state — the model's ``state_dict``
under the reference's key names, the optimizer's state, step, epoch, the
dropout generator's state and the run-control scalars — written with
``torch.save`` to one file, so training survives a preemption. Bare ``.pth``
weight files (``save_params_only``) stay readable by the reference's
converter.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # dropout masks; lives on the model's device
    step: int = 0


def make_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                     device: torch.device, seed: int = 666) -> TrainState:
    """The state of a fresh run. The dropout generator is seeded from
    ``seed`` on ``device`` and handed to the model."""
    generator = torch.Generator(device=device).manual_seed(seed)
    model.set_dropout_generator(generator)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def save_checkpoint(path: str, state: TrainState, *, epoch: int = 0,
                    run_ctl: Optional[Dict[str, float]] = None) -> None:
    """``run_ctl`` carries flat float scalars of run-control state (earlystop
    best/counter, scheduler internals) so a resumed run makes the same
    save/stop/LR decisions as an uninterrupted one. They are stored as
    float64: LRs and metric bests must round-trip exactly."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": state.generator.get_state(),
    }
    if run_ctl:
        payload["run_ctl"] = {k: torch.tensor(float(v), dtype=torch.float64)
                              for k, v in run_ctl.items()}
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a crash mid-write never leaves half a checkpoint


def restore_checkpoint(path: str, state: TrainState
                       ) -> Tuple[TrainState, int, Optional[Dict[str, float]]]:
    """Load ``path`` into ``state`` in place -> (state, epoch, run_ctl dict or
    None when the checkpoint carries none)."""
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    run_ctl = None
    if "run_ctl" in payload:
        run_ctl = {k: float(v) for k, v in payload["run_ctl"].items()}
    return state, int(payload["epoch"]), run_ctl


def save_params_only(path: str, model: nn.Module) -> None:
    """Inference-weight export: a ``.pth`` state_dict under the reference's
    key names, float32 on the CPU."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()}, path)
