"""Caption losses as exact sum/count parts (port of
``vct_tpu/models/losses.py:33-117``).

* ``cross_entropy`` — ``nn.CrossEntropyLoss(ignore_index=pad)``: mean of
  ``-log_softmax[label]`` over non-pad labels.
* ``sce_loss`` — symmetric cross-entropy ``alpha * CE + beta * RCE`` with a
  clamped one-hot. The RCE term averages over every position of the batch's
  rectangle, pads included, while CE ignores pads; ``rect_mask`` selects the
  positions inside the rectangle of the batch's longest caption.

Everything is float32 whatever the logits' dtype. The contrastive matching
losses come with the matching task.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG_OFF = math.log(1e-4)  # log of the clamped one-hot's off-label value
EPS = 1e-7                # softmax clip floor


def cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 0,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, V], labels [N] -> (nll sum, contributing count) over the
    non-ignored positions; ``valid`` [N] bool also drops filler positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    keep = (labels != ignore_index).float()
    if valid is not None:
        keep = keep * valid.float()
    return (nll * keep).sum(), keep.sum()


def cross_entropy(logits, labels, ignore_index: int = 0, valid=None) -> torch.Tensor:
    s, n = cross_entropy_parts(logits, labels, ignore_index, valid)
    return s / n.clamp(min=1.0)


def sce_loss_parts(logits: torch.Tensor, labels: torch.Tensor, *, ignore_index: int = 0,
                   rect_mask: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None):
    """-> (ce_sum, ce_n, rce_sum, rce_n)."""
    ce_sum, ce_n = cross_entropy_parts(logits, labels, ignore_index, valid)
    p = torch.softmax(logits.float(), dim=-1).clamp(EPS, 1.0)
    # log(clamped one-hot) is 0 at the label and log(1e-4) elsewhere, so
    # rce_i = -log(1e-4) * (sum_j p_ij - p_i[label]) with the clamped p
    p_label = p.gather(1, labels.long()[:, None])[:, 0]
    rce = -(p.sum(dim=-1) - p_label) * LOG_OFF
    m = torch.ones_like(rce) if rect_mask is None else rect_mask.float()
    if valid is not None:
        m = m * valid.float()
    return ce_sum, ce_n, (rce * m).sum(), m.sum()


def sce_loss(logits, labels, *, alpha: float, beta: float, ignore_index: int = 0,
             rect_mask=None, valid=None) -> torch.Tensor:
    ce_sum, ce_n, rce_sum, rce_n = sce_loss_parts(
        logits, labels, ignore_index=ignore_index, rect_mask=rect_mask, valid=valid)
    return alpha * ce_sum / ce_n.clamp(min=1.0) + beta * rce_sum / rce_n.clamp(min=1.0)
