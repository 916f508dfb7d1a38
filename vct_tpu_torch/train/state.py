"""Train state and checkpoints (port of ``vct_tpu/train/state.py``).

A checkpoint is the complete training state — the model's ``state_dict``
under the reference's key names, the optimizer's state, step, epoch, the
dropout generator's state and the run-control scalars — written with
``torch.save`` to one file, so training survives a preemption. Bare ``.pth``
weight files (``save_params_only``) stay readable by the reference's
converter.

Over a mesh (``parallel.mesh``) every rank takes part in a save (tensor
parallel shards are gathered whole) and rank 0 alone writes: the tensors are
whole, with no DDP ``module.`` prefix, so a checkpoint loads at any world
size. It holds every rank's dropout generator state; a resume at the same
world size gives each rank its own back.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vct_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    full_optimizer_state,
    full_state_dict,
    gather_world,
    load_full_optimizer_state,
    load_full_state_dict,
)
from vct_tpu_torch.train.optimizers import settle_optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # dropout masks; lives on the model's device
    step: int = 0
    reseeded: bool = False  # the last restore re-seeded the generator
    # restores so far: a restore gives the optimizer new state tensors, so a
    # train step's CUDA graphs (``train.step.GraphedTrainStep``) captured
    # before it are dropped
    restores: int = 0


def rank_seed(seed: int, data_index: int) -> int:
    """The dropout seed of the ranks at ``data_index``: data rank 0 keeps
    ``seed``, so one rank under a process group draws what one process draws.
    Ranks of one model row share it: their replicated activations must drop
    alike."""
    return seed if data_index == 0 else seed + 1_000_003 * data_index


def make_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                     device: torch.device, seed: int = 666) -> TrainState:
    """The state of a fresh run. The dropout generator is seeded from
    ``seed`` on ``device`` and handed to the model."""
    generator = torch.Generator(device=device).manual_seed(seed)
    model.set_dropout_generator(generator)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def save_checkpoint(path: str, state: TrainState, *, epoch: int = 0,
                    run_ctl: Optional[Dict[str, float]] = None,
                    mesh: Optional[Mesh] = None) -> None:
    """``run_ctl`` carries flat float scalars of run-control state (earlystop
    best/counter, scheduler internals) so a resumed run makes the same
    save/stop/LR decisions as an uninterrupted one. They are stored as
    float64: LRs and metric bests must round-trip exactly. Over a mesh every
    rank calls it, rank 0 writes, and every rank returns once the file is
    there."""
    mesh = mesh or Mesh()
    gen = state.generator.get_state()  # where the last step, eager or replayed, left it
    payload = {
        "model": full_state_dict(mesh, state.model),
        "optimizer": full_optimizer_state(mesh, state.model, state.optimizer),
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": gen,
        "generators": [g.round().to(torch.uint8).cpu() for g in
                       gather_world(gen.to(mesh.device, torch.float32), mesh)],
    }
    if mesh.is_main:
        if run_ctl:
            payload["run_ctl"] = {k: torch.tensor(float(v), dtype=torch.float64)
                                  for k, v in run_ctl.items()}
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a crash mid-write never leaves half a checkpoint
    barrier(mesh)


def restore_checkpoint(path: str, state: TrainState, *, mesh: Optional[Mesh] = None
                       ) -> Tuple[TrainState, int, Optional[Dict[str, float]]]:
    """Load ``path`` into ``state`` in place -> (state, epoch, run_ctl dict or
    None when the checkpoint carries none). A checkpoint written at another
    world size holds no generator state for this rank: the generator is left
    as it is and ``state.reseeded`` set, for the caller to re-seed it. The
    optimizer's update is set up for this device again (``settle_optimizer``:
    the checkpoint may come from the host or the card), and
    ``state.restores`` counts the restore."""
    mesh = mesh or Mesh()
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    load_full_state_dict(mesh, state.model, payload["model"])
    load_full_optimizer_state(mesh, state.model, state.optimizer, payload["optimizer"])
    settle_optimizer(state.optimizer)
    state.restores += 1
    gens = payload.get("generators", [payload["generator"]])
    state.reseeded = len(gens) != mesh.world
    if not state.reseeded:
        state.generator.set_state(gens[mesh.rank].cpu())
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
