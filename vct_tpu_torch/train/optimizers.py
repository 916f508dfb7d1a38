"""Optimizers, LR schedules and task freezing (port of
``vct_tpu/train/optimizers.py``).

Adam / AdamW / SGD selected by ``train.optimizer.name`` on ``torch.optim``;
CosineAnnealingLR or ReduceLROnPlateau stepped per epoch as host-side objects
with torch's own semantics, whose LR is pushed into the optimizer's param
groups (on a card into a device tensor, in place: ``settle_optimizer``). Freezing follows the reference's ``mode`` switch: a frozen module's
parameters are simply not handed to the optimizer (the loss still flows
through them).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from vct_tpu_torch.config import TrainConfig


# ---------------------------------------------------------------------------
# host-side schedulers (torch semantics, stepped per epoch)
# ---------------------------------------------------------------------------


class CosineAnnealingLR:
    """torch.optim.lr_scheduler.CosineAnnealingLR:
    lr(e) = eta_min + (base - eta_min) * (1 + cos(pi * e / T_max)) / 2."""

    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        self.base_lr = base_lr
        self.T_max = T_max
        self.eta_min = eta_min
        self.epoch = 0

    def step(self) -> float:
        self.epoch += 1
        return self.lr

    @property
    def lr(self) -> float:
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.epoch / self.T_max))
            / 2
        )

    # run-control checkpointing (flat float scalars; see state.save_checkpoint)
    def state_dict(self) -> Dict[str, float]:
        return {"epoch": float(self.epoch)}

    def load_state_dict(self, sd: Dict[str, float]) -> None:
        self.epoch = int(sd["epoch"])


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau (min mode, default
    threshold=1e-4 in 'rel' mode: improvement iff metric < best * (1 - 1e-4),
    matching torch's ``_is_better``)."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        self.current = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.current = max(self.current * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    @property
    def lr(self) -> float:
        return self.current

    def state_dict(self) -> Dict[str, float]:
        return {
            "current": float(self.current),
            "best": float("nan") if self.best is None else float(self.best),
            "bad_epochs": float(self.bad_epochs),
        }

    def load_state_dict(self, sd: Dict[str, float]) -> None:
        self.current = float(sd["current"])
        self.best = None if math.isnan(sd["best"]) else float(sd["best"])
        self.bad_epochs = int(sd["bad_epochs"])


class ConstantLR:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr

    def step(self, *_: Any) -> float:
        return self.base_lr

    @property
    def lr(self) -> float:
        return self.base_lr

    def state_dict(self) -> Dict[str, float]:
        return {}

    def load_state_dict(self, sd: Dict[str, float]) -> None:
        pass


def build_scheduler(cfg: TrainConfig):
    s = cfg.lr_scheduler
    base = cfg.optimizer.learning_rate
    if s.name == "CosineAnnealingLR":
        return CosineAnnealingLR(base, s.T_max, s.eta_min)
    if s.name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(base, s.factor, s.patience)
    return ConstantLR(base)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

FROZEN_ROOTS = {"caption": {"matching"}, "match": {"cap_decoder"}, "cross": set()}


def freeze_labels(model: nn.Module, task: str) -> Dict[str, str]:
    """Parameter name -> 'train' / 'frozen' by top-level module: caption
    freezes ``matching``, match freezes ``cap_decoder``, cross trains both."""
    frozen = FROZEN_ROOTS[task]
    return {name: ("frozen" if name.split(".", 1)[0] in frozen else "train")
            for name, _ in model.named_parameters()}


def build_optimizer(cfg: TrainConfig, model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer over the task's trainable parameters, set up for their
    device by ``settle_optimizer``."""
    labels = freeze_labels(model, cfg.task)
    params = [p for name, p in model.named_parameters() if labels[name] == "train"]
    o = cfg.optimizer
    betas = (o.beta[0], o.beta[1])
    if o.name == "adam":
        if o.weight_decay:
            # the reference dispatch: 'adam' with weight_decay != 0 builds AdamW
            # (decoupled decay)
            opt = torch.optim.AdamW(params, lr=o.learning_rate, betas=betas,
                                    weight_decay=o.weight_decay)
        else:
            opt = torch.optim.Adam(params, lr=o.learning_rate, betas=betas)
    elif o.name == "adamw":
        opt = torch.optim.AdamW(params, lr=o.learning_rate, betas=betas,
                                weight_decay=o.weight_decay)
    elif o.name == "sgd":
        opt = torch.optim.SGD(params, lr=o.learning_rate, momentum=o.momentum or 0.0)
    else:
        raise ValueError(f"unsupported optimizer: {o.name}")
    return settle_optimizer(opt)


def settle_optimizer(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Set each param group's update up for its parameters' device, in place.

    On a card the update must be one that a CUDA graph can capture and
    replay (``train.step.GraphedTrainStep``): the learning rate is a float32
    device tensor, which ``set_learning_rate`` fills in place so that a
    replay reads the new value; Adam and AdamW run ``capturable`` (step
    count and bias corrections on the device); SGD runs ``fused``, whose
    update takes a tensor learning rate on the device (the default
    multi-tensor SGD reads a tensor learning rate on the host, which a
    capture refuses). On the host: float learning rates, neither flag. Call
    it again after ``load_state_dict``, whose param groups are the
    checkpoint's."""
    for group in optimizer.param_groups:
        if not group["params"]:
            continue
        dev = group["params"][0].device
        card = dev.type == "cuda"
        lr = group["lr"]
        if card:
            if not (isinstance(lr, torch.Tensor) and lr.device == dev
                    and lr.dtype == torch.float32):
                group["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        else:
            group["lr"] = float(lr)
        if "capturable" in group:  # Adam, AdamW
            group["capturable"] = card
            for p in group["params"]:
                step = optimizer.state.get(p, {}).get("step")
                if isinstance(step, torch.Tensor):
                    optimizer.state[p]["step"] = step.to(dev if card else "cpu",
                                                         torch.float32)
        elif isinstance(optimizer, torch.optim.SGD):
            group["fused"] = True if card else None
    # every shape's first train step on the card runs eagerly by design: the
    # once-per-optimizer warning that a capturable optimizer stepped outside
    # a capture says nothing here
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Push a host-scheduler LR into every param group (in place where the
    group holds a device tensor, so CUDA graphs of the step see it)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None
