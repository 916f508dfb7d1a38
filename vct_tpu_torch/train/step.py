"""Train and validation steps (port of ``vct_tpu/train/step.py``).

The train step is forward in training mode (dropout from the state's
generator), ``backward``, one optimizer update. In one process on a card it
is one CUDA graph per batch shape (``GraphedTrainStep``, the counterpart of
the reference's ``jax.jit`` with donated state), and so is the validation
step (``GraphedEvalStep``); on the host, and over a mesh with a process
group, both run eagerly. With the fused loss
on and an eligible shape on a CUDA device it launches the three loss kernels
once each (caption and cross tasks); the validation step launches the two
forward ones. The match and cross tasks take the batch's frozen text features
(``text_feat``, from ``batch_to_arrays`` with a text encoder). The loss the
train step returns stays on the device: callers fetch it when they need it.

Over a mesh with a process group (``parallel.mesh``) each rank takes its rows
of the global batch, and the step is the one-device step on the joined batch:

* the task loss runs inside ``TaskLoss.forward`` under
  ``DistributedDataParallel`` over the data group (DDP reduces gradients only
  for what went through its ``forward``);
* caption: the token counts are summed over the ranks before dividing, and
  the rank's share is scaled by the data size, so DDP's mean of the rank
  gradients is the gradient of ``alpha * sum(ce) / sum(n_ce) + (1 - alpha) *
  sum(rce) / sum(n_rce)`` over the global batch; the RCE rectangle is the
  global batch's longest caption;
* match / cross: the text and video features are gathered over the data
  group (``gather_rows``), so every rank builds the global [B, B] matrix;
* the metrics are the global loss on every rank.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vct_tpu_torch import graphs, tracing
from vct_tpu_torch.parallel.mesh import Mesh, all_reduce_max, all_reduce_sum, gather_rows
from vct_tpu_torch.train.state import TrainState

TASKS = ("caption", "match", "cross")


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"unknown task {task}")


def _mesh_hooks(mesh: Optional[Mesh], batch: Dict[str, Any]):
    """(rect_len, rows) for a rank's share of a global batch: the longest
    caption of the global batch, and the row gather of the contrastive loss.
    Both None off a mesh or at data size 1 (the rows are the global batch)."""
    if mesh is None or mesh.data == 1:
        return None, None
    rect_len = None
    if "token_mask" in batch:
        rect_len = all_reduce_max((~batch["token_mask"]).sum(dim=1).max().float(),
                                  mesh.data_group)
    return rect_len, (lambda x: gather_rows(x, mesh))


def task_loss(model, task: str, batch: Dict[str, Any], mesh: Mesh):
    """-> (objective, metrics) of this rank's share of the global batch: DDP's
    mean of the objectives' gradients over the data group is the gradient of
    the task loss on the joined batch, and ``metrics`` hold that loss. On one
    process (``Mesh()``) the share is the batch and the objective its loss."""
    n, group = mesh.data, mesh.data_group
    rect_len, rows = _mesh_hooks(mesh, batch)
    feats, masks, valid = batch["feats"], batch.get("masks"), batch.get("row_valid")
    if task == "match":
        loss = model.match_loss(feats, masks, batch["text_feat"], row_valid=valid, rows=rows)
        return loss, {"loss": loss.detach(), "match_loss": loss.detach()}
    if task == "caption":
        parts = model.caption_loss_parts(feats, masks, batch["token_ids"],
                                         batch["token_mask"], row_valid=valid,
                                         rect_len=rect_len)
    else:
        *parts, match = model.cross_loss_parts(feats, masks, batch["token_ids"],
                                               batch["token_mask"], batch["text_feat"],
                                               row_valid=valid, rect_len=rect_len, rows=rows)
    ce_sum, ce_n, rce_sum, rce_n = parts
    counts = all_reduce_sum(torch.stack([ce_n, rce_n]), group)
    alpha = model.cap_decoder.sce_loss_alpha
    cap_share = (alpha * ce_sum / counts[0].clamp(min=1.0)
                 + (1.0 - alpha) * rce_sum / counts[1].clamp(min=1.0))
    cap = all_reduce_sum(cap_share.detach(), group)
    if task == "caption":
        return cap_share * n, {"loss": cap, "cap_loss": cap}
    beta = model.config.loss_beta
    objective = beta * (cap_share * n) + (1.0 - beta) * match
    loss = beta * cap + (1.0 - beta) * match.detach()
    return objective, {"loss": loss, "cap_loss": cap, "match_loss": match.detach()}


class TaskLoss(nn.Module):
    """The task loss over the mesh as a module: ``forward(batch)`` ->
    (objective, metrics). DDP wraps this, not the model, because DDP
    reduces the gradients only of what ran through its ``forward``."""

    def __init__(self, model: nn.Module, task: str, mesh: Mesh):
        super().__init__()
        self.model, self.task, self.mesh = model, task, mesh

    def forward(self, batch: Dict[str, Any]):
        return task_loss(self.model, self.task, batch, self.mesh)


def wrap_ddp(module: nn.Module, mesh: Mesh) -> nn.Module:
    """``module`` under DDP over the mesh's data group (plain in one process,
    and when the data column is one rank of a larger group: tensor
    parallelism alone). The
    caption task never reaches a configured matching head, so unused
    parameters are looked for; the buffers are constants."""
    if mesh.data_group is None:
        return module
    from torch.nn.parallel import DistributedDataParallel

    dev = mesh.device
    with warnings.catch_warnings():  # newer torch names broadcast_buffers deprecated
        warnings.filterwarnings("ignore", message=".*broadcast_buffers", category=FutureWarning)
        return DistributedDataParallel(module,
                                       device_ids=[dev] if dev.type == "cuda" else None,
                                       process_group=mesh.data_group,
                                       broadcast_buffers=False, find_unused_parameters=True)


def _update(state: TrainState, loss_fn: Callable, batch: Dict[str, Any]
            ) -> Dict[str, torch.Tensor]:
    """Forward, ``backward()`` and one optimizer update on gradients that
    start from None -> the step's metrics."""
    loss, metrics = loss_fn(batch)
    loss.backward()
    state.optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def _eager_train_step(task: str, mesh: Mesh) -> Callable:
    """The step as eager PyTorch; over a process group the task loss runs
    under DDP (built at the first call, collectively)."""
    wrapped: Dict[str, nn.Module] = {}

    def step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if wrapped.get("model") is not model:
            wrapped.update(model=model, loss=wrap_ddp(TaskLoss(model, task, mesh), mesh))
        metrics = _update(state, wrapped["loss"], batch)
        state.step += 1
        return state, metrics

    return step


class GraphedTrainStep(graphs.Staged):
    """``(state, batch) -> (state, metrics)``, the counterpart of the JAX
    package's ``jax.jit(step, donate_argnums=(0,))`` in one process: a
    ``graphs.Staged`` runner of one stage (gradients set to None, forward,
    ``backward()``, ``optimizer.step()``).

    Each batch shape (every tensor's shape, dtype and device, ``text_feat``
    included) gets static input buffers. On CPU tensors the stage runs on
    them, with no graph. On CUDA tensors a shape's first call runs the step
    eagerly on a side stream (a real step: the call answers from it), then
    captures it as one CUDA graph into the shape's own memory pool, with the
    state's dropout generator registered; every later call copies the batch
    in and replays.
    The parameters, the optimizer's state and its learning rate (a device
    tensor that ``optimizers.set_learning_rate`` fills in place) keep their
    addresses, so a replay updates them in place, as the donated JAX state
    is; each replay advances the generator's offset as the eager step would,
    and ``state.step`` stays a host counter, bumped here. The metrics are
    clones. A new model, optimizer or generator, or a
    ``state.restore_checkpoint`` (which gives the optimizer new state
    tensors), drops the graphs. A failed capture or replay raises: nothing
    falls back to the eager step. ``eager`` is the eager step itself, the
    same object's update, for comparisons on the card."""

    def __init__(self, task: str):
        super().__init__([self._stage], lambda st: {k: v.clone() for k, v in st["out"].items()})
        self.task = task
        self.eager = _eager_train_step(task, Mesh())
        self._state: Optional[TrainState] = None

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        self.own((state.model, state.optimizer, state.generator), state.restores)
        self._state, self.generators = state, (state.generator,)
        state.model.train()
        metrics = self.run(batch)
        state.step += 1
        return state, metrics

    def _stage(self, st: Dict[str, Any]) -> None:
        state = self._state
        # None here: under capture the gradients are made by backward() in
        # the graph's pool, where every replay writes them again
        state.optimizer.zero_grad(set_to_none=True)
        st["out"] = _update(state, lambda b: task_loss(state.model, self.task, b, Mesh()), st)


def make_train_step(task: str, mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """One optimizer step. In one process (``mesh`` None or without a
    process group) a ``GraphedTrainStep``: CUDA graphs on the card, none on
    the host. With a ``mesh`` that has a process group (a data group
    under DDP, or tensor parallelism) the step stays eager: the batch is this
    rank's share of the global batch (``parallel.mesh.shard_batch``) and the
    task loss runs under DDP, whose reducer and gloo's collectives a CUDA
    graph does not capture."""
    _check_task(task)
    if mesh is not None and mesh.distributed:
        return _eager_train_step(task, mesh)
    return GraphedTrainStep(task)


def _eager_eval_step(task: str, mesh: Optional[Mesh]) -> Callable:
    @torch.no_grad()
    def step(model, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        rect_len, rows = _mesh_hooks(mesh, batch)
        feats, masks, valid = batch["feats"], batch.get("masks"), batch.get("row_valid")
        # a fill, not a copy from the host: a CUDA graph may be capturing
        n_valid = (valid.float().sum() if valid is not None
                   else torch.full((), float(feats[0].shape[0]), device=feats[0].device))
        if rows is not None:
            n_valid = all_reduce_sum(n_valid, mesh.data_group)
            if mesh.data_index:
                n_valid = torch.zeros_like(n_valid)
        if task == "match":
            loss = model.match_loss(feats, masks, batch["text_feat"], row_valid=valid,
                                    rows=rows)
            return {"match_sum": loss * n_valid, "match_n": n_valid}
        if task == "caption":
            parts = model.caption_loss_parts(feats, masks, batch["token_ids"],
                                             batch["token_mask"], row_valid=valid,
                                             rect_len=rect_len)
        else:
            *parts, match = model.cross_loss_parts(feats, masks, batch["token_ids"],
                                                   batch["token_mask"], batch["text_feat"],
                                                   row_valid=valid, rect_len=rect_len,
                                                   rows=rows)
        out = dict(zip(("ce_sum", "ce_n", "rce_sum", "rce_n"), parts))
        if task == "cross":
            out.update(match_sum=match * n_valid, match_n=n_valid)
        return out

    return step


class GraphedEvalStep(graphs.Staged):
    """``(model, batch) -> parts``, the counterpart of the JAX package's
    ``jax.jit`` of the validation step in one process: a ``graphs.Staged``
    runner of the eager step, one CUDA graph per batch shape on the card,
    captured in ``eval()`` mode under ``no_grad`` after the shape's first
    (eager) call and replayed after. The parts are clones. Another model
    drops the graphs (the weights are read where the capture saw them:
    training updates them in place). ``eager`` is the eager step."""

    def __init__(self, task: str):
        super().__init__([self._stage], lambda st: {k: v.clone() for k, v in st["out"].items()})
        self.eager = _eager_eval_step(task, None)
        self._model: Optional[nn.Module] = None

    @torch.no_grad()
    def __call__(self, model, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self.own((model,))
        self._model = model
        model.eval()
        return self.run(batch)

    def _stage(self, st: Dict[str, Any]) -> None:
        st["out"] = self.eager(self._model, st)


def make_eval_step(task: str, mesh: Optional[Mesh] = None):
    """Forward-only validation step without dropout. Returns exact SUM/COUNT
    parts, not per-batch means, so the caller's aggregation does not depend on
    how the split was batched and collate filler rows contribute nothing.
    In one process a ``GraphedEvalStep`` (CUDA graphs on the card). Over a
    mesh with a process group the step is eager and the parts are this
    rank's share (``reduce_eval_parts`` sums them over the data group); the
    contrastive loss spans the global batch and is counted by data rank 0
    alone."""
    _check_task(task)
    if mesh is not None and mesh.distributed:
        return _eager_eval_step(task, mesh)
    return GraphedEvalStep(task)


def reduce_eval_parts(parts: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                      ) -> Dict[str, float]:
    """Sum eval parts (each a tensor, any shape) over the batches and, on a
    mesh, over the data group, in float64 -> host floats."""
    keys = sorted(parts)
    local = torch.stack([parts[k].double().sum() for k in keys])
    if mesh is not None and mesh.data > 1:
        local = all_reduce_sum(local, mesh.data_group)
    return dict(zip(keys, local.tolist()))


def combine_eval_parts(task: str, agg: Dict[str, float], *, sce_alpha: float,
                       loss_beta: float) -> Dict[str, float]:
    """Host-side reduction of summed eval-step parts -> metric dict with the
    reference's keys (loss / cap_loss / match_loss)."""
    out: Dict[str, float] = {}
    if "ce_sum" in agg:
        ce = agg["ce_sum"] / max(agg["ce_n"], 1.0)
        rce = agg["rce_sum"] / max(agg["rce_n"], 1.0)
        out["cap_loss"] = sce_alpha * ce + (1.0 - sce_alpha) * rce
    if "match_sum" in agg:
        out["match_loss"] = agg["match_sum"] / max(agg["match_n"], 1.0)
    if task == "caption":
        out["loss"] = out["cap_loss"]
    elif task == "match":
        out["loss"] = out["match_loss"]
    else:
        out["loss"] = loss_beta * out["cap_loss"] + (1.0 - loss_beta) * out["match_loss"]
    return out


def batch_to_arrays(batch, device: torch.device, text_encoder=None) -> Dict[str, Any]:
    """collate.Batch -> the dict of tensors on ``device`` the steps consume;
    with ``text_encoder`` (``List[str] -> [B, dim]``) also the captions' frozen
    text features. A ``data.to_device`` span."""

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

    with tracing.span("data.to_device"):
        b = batch.feats[0].shape[0]
        out: Dict[str, Any] = {
            "feats": [put(f) for f in batch.feats],
            "masks": [put(m) for m in batch.masks],
            # leading-rows-real mask. None (not 0) means "all rows real":
            # collate always sets n_valid >= 1, and `or b` would count filler
            # rows if a constructor left the field at a falsy default.
            "row_valid": put(np.arange(b) < (b if batch.n_valid is None else batch.n_valid)),
        }
        if batch.token_ids is not None:
            out["token_ids"] = put(batch.token_ids)
            out["token_mask"] = put(batch.token_mask)
        if text_encoder is not None:
            out["text_feat"] = text_encoder(list(batch.captions)).to(device)
        return out
