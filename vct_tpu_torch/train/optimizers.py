"""Optimizers, LR schedules and task freezing (port of
``vct_tpu/train/optimizers.py``).

Adam / AdamW / SGD selected by ``train.optimizer.name`` on ``torch.optim``
(Adam and AdamW as subclasses whose update is one pass of
``ops.optim_kernels.adam_update``); CosineAnnealingLR or ReduceLROnPlateau
stepped per epoch as host-side objects with torch's own semantics, whose LR
is pushed into the optimizer's param groups (on a card into a device tensor,
in place: ``settle_optimizer``). Freezing follows the reference's ``mode``
switch: a frozen module's parameters are simply not handed to the optimizer
(the loss still flows through them).
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


class _OnePassAdam:
    """``step()`` of torch's Adam and AdamW as one ``adam_update`` a param
    group: the kernel on the card (launched eagerly, or captured by a CUDA
    graph of the train step), its plain version on the host. Everything
    else is torch's: the param groups (``lr``, ``betas``, ``eps``,
    ``weight_decay``, ``capturable``), ``state[p]`` with ``step`` (a 0-dim
    float32 tensor on the parameter's device), ``exp_avg`` and
    ``exp_avg_sq``, ``state_dict`` and ``load_state_dict``: a checkpoint of
    torch's Adam loads here and the other way round. AMSGrad, ``maximize``
    and Adam's L2 decay (``weight_decay`` without ``decoupled_weight_decay``,
    which ``build_optimizer`` never builds) are refused."""

    def __init__(self, params, **kw):
        # imported with the first optimizer, before any capture of its step,
        # so that graphs.counters() holds the update's counters from then on
        from vct_tpu_torch.ops import optim_kernels  # noqa: F401

        super().__init__(params, **kw)
        for group in self.param_groups:
            _refuse(group)

    @torch.no_grad()
    def step(self, closure=None):
        from vct_tpu_torch.ops.optim_kernels import adam_update

        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            _refuse(group)
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state_of(p) for p in params]
            decay = group["weight_decay"] if group.get("decoupled_weight_decay") else 0.0
            adam_update(params, [p.grad for p in params], [s["exp_avg"] for s in states],
                        [s["exp_avg_sq"] for s in states], [s["step"] for s in states],
                        lr=group["lr"], betas=group["betas"], eps=group["eps"],
                        weight_decay=decay)
        return loss

    def _state_of(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = self.state[p]
        if not state:  # torch's lazy state, its step on the parameter's device
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state


def _refuse(group: Dict[str, Any]) -> None:
    for key in ("amsgrad", "maximize"):
        if group.get(key):
            raise ValueError(f"{key}: the one-pass Adam update does not run it")
    if group["weight_decay"] and not group.get("decoupled_weight_decay"):
        raise ValueError("Adam's L2 weight decay: the one-pass update decays decoupled "
                         "(AdamW) only")


class Adam(_OnePassAdam, torch.optim.Adam):
    pass


class AdamW(_OnePassAdam, torch.optim.AdamW):
    pass


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
            opt = AdamW(params, lr=o.learning_rate, betas=betas,
                        weight_decay=o.weight_decay)
        else:
            opt = Adam(params, lr=o.learning_rate, betas=betas)
    elif o.name == "adamw":
        opt = AdamW(params, lr=o.learning_rate, betas=betas, weight_decay=o.weight_decay)
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
    replay reads the new value; Adam and AdamW keep their step counts on the
    device, where the one-pass update reads them (``capturable``, which also
    keeps them there through torch's ``load_state_dict``); SGD runs
    ``fused``, whose update takes a tensor learning rate on the device (the
    default multi-tensor SGD reads a tensor learning rate on the host, which
    a capture refuses). On the host: float learning rates, neither flag.
    Call it again after ``load_state_dict``, whose param groups are the
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
