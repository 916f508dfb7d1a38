"""Train and validation steps on one device (port of ``vct_tpu/train/step.py``).

The train step is eager PyTorch: forward in training mode (dropout from the
state's generator), ``backward``, one optimizer update. With the fused loss
on and an eligible shape on a CUDA device it launches the three loss kernels
once each (caption and cross tasks); the validation step launches the two
forward ones. The match and cross tasks take the batch's frozen text features
(``text_feat``, from ``batch_to_arrays`` with a text encoder). The loss the
train step returns stays on the device: callers fetch it when they need it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from vct_tpu_torch.train.state import TrainState

TASKS = ("caption", "match", "cross")


def _check_task(task: str) -> None:
    if task not in TASKS:
        raise ValueError(f"unknown task {task}")


def _task_loss(model, task: str, batch: Dict[str, Any]):
    """-> (loss, metrics) of one task on one batch."""
    feats, masks, valid = batch["feats"], batch.get("masks"), batch.get("row_valid")
    if task == "caption":
        loss = model.caption_loss(feats, masks, batch["token_ids"], batch["token_mask"],
                                  row_valid=valid)
        return loss, {"loss": loss, "cap_loss": loss}
    if task == "match":
        loss = model.match_loss(feats, masks, batch["text_feat"], row_valid=valid)
        return loss, {"loss": loss, "match_loss": loss}
    loss, cap, match = model.cross_loss(feats, masks, batch["token_ids"], batch["token_mask"],
                                        batch["text_feat"], row_valid=valid)
    return loss, {"loss": loss, "cap_loss": cap, "match_loss": match}


def make_train_step(task: str) -> Callable[[TrainState, Dict[str, Any]],
                                           Tuple[TrainState, Dict[str, torch.Tensor]]]:
    _check_task(task)

    def step(state: TrainState, batch: Dict[str, Any]):
        model, optimizer = state.model, state.optimizer
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = _task_loss(model, task, batch)
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(task: str):
    """Forward-only validation step without dropout. Returns exact SUM/COUNT
    parts, not per-batch means, so the caller's aggregation does not depend on
    how the split was batched and collate filler rows contribute nothing."""
    _check_task(task)

    @torch.no_grad()
    def step(model, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        feats, masks, valid = batch["feats"], batch.get("masks"), batch.get("row_valid")
        n_valid = (valid.float().sum() if valid is not None
                   else torch.tensor(float(feats[0].shape[0]), device=feats[0].device))
        if task == "match":
            loss = model.match_loss(feats, masks, batch["text_feat"], row_valid=valid)
            return {"match_sum": loss * n_valid, "match_n": n_valid}
        if task == "caption":
            parts = model.caption_loss_parts(feats, masks, batch["token_ids"],
                                             batch["token_mask"], row_valid=valid)
        else:
            *parts, match = model.cross_loss_parts(feats, masks, batch["token_ids"],
                                                   batch["token_mask"], batch["text_feat"],
                                                   row_valid=valid)
        out = dict(zip(("ce_sum", "ce_n", "rce_sum", "rce_n"), parts))
        if task == "cross":
            out.update(match_sum=match * n_valid, match_n=n_valid)
        return out

    return step


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
    text features."""

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

    b = batch.feats[0].shape[0]
    out: Dict[str, Any] = {
        "feats": [put(f) for f in batch.feats],
        "masks": [put(m) for m in batch.masks],
        # leading-rows-real mask. None (not 0) means "all rows real": collate
        # always sets n_valid >= 1, and `or b` would count filler rows if a
        # constructor left the field at a falsy default.
        "row_valid": put(np.arange(b) < (b if batch.n_valid is None else batch.n_valid)),
    }
    if batch.token_ids is not None:
        out["token_ids"] = put(batch.token_ids)
        out["token_mask"] = put(batch.token_mask)
    if text_encoder is not None:
        out["text_feat"] = text_encoder(list(batch.captions)).to(device)
    return out
