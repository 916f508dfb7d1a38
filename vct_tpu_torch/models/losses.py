"""Caption losses as exact sum/count parts, and the contrastive matching
losses (port of ``vct_tpu/models/losses.py``).

* ``cross_entropy`` — ``nn.CrossEntropyLoss(ignore_index=pad)``: mean of
  ``-log_softmax[label]`` over non-pad labels.
* ``sce_loss`` — symmetric cross-entropy ``alpha * CE + beta * RCE`` with a
  clamped one-hot. The RCE term averages over every position of the batch's
  rectangle, pads included, while CE ignores pads; ``rect_mask`` selects the
  positions inside the rectangle of the batch's longest caption.

* ``clip_symmetric_loss`` (CSL) and ``clip_symmetric_loss_wds`` (CSL with
  dual softmax) over a [B, B] video-text similarity, with ``valid`` masking
  collate filler rows out as anchors and as negatives.

Everything is float32 whatever the inputs' dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG_OFF = math.log(1e-4)  # log of the clamped one-hot's off-label value
EPS = 1e-7                # softmax clip floor
NEG_INF = -1e30           # large-finite mask value


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


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


def _symmetric_ce(sim: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric CE over a [B, B] similarity matrix. ``valid`` [B] bool
    restricts it to the leading real sub-batch: filler rows and columns
    (repeated row 0 from ``collate``) act as neither anchors nor negatives,
    so the result equals the loss over the [B', B'] sub-matrix, which is what
    the reference computes on its ragged final batch."""
    if valid is not None:
        # large-finite (not -inf): filler rows then softmax to a uniform
        # distribution instead of NaN, and their nll is weighted out below
        col_bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
        sim = sim + col_bias[None, :] + col_bias[:, None]
    nll_v = -torch.log_softmax(sim, dim=-1).diagonal()
    nll_t = -torch.log_softmax(sim.T, dim=-1).diagonal()
    if valid is None:
        return (nll_v.mean() + nll_t.mean()) / 2.0
    w = valid.float()
    n = w.sum().clamp(min=1.0)
    return ((nll_v * w).sum() + (nll_t * w).sum()) / (2.0 * n)


def clip_symmetric_loss(video: torch.Tensor, text: torch.Tensor,
                        temperature: Optional[torch.Tensor] = None,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSL (reference ``loss.py:18-35``): the similarity scaled by
    ``exp(temperature)`` when one is given."""
    sim = _l2_normalize(video) @ _l2_normalize(text).T
    if temperature is not None:
        sim = sim * torch.exp(temperature.float())
    return _symmetric_ce(sim, valid)


def clip_symmetric_loss_wds(video: torch.Tensor, text: torch.Tensor,
                            temperature: Optional[torch.Tensor] = None,
                            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSL with dual softmax (reference ``loss.py:52-66``). The argument order
    is (video, text), so ``sim[i, j] = vid_i . text_j`` is the reference's
    matrix transposed and its ``softmax(sim, dim=0)`` (texts per video) is a
    softmax over dim 1 here. Temperature 1.0 when none is given. With
    ``valid`` the dual softmax runs over the valid sub-batch only, scaled by
    the real batch size (the reference multiplies by ``len(sim)`` of its
    ragged batch)."""
    sim = _l2_normalize(video) @ _l2_normalize(text).T
    tem = torch.ones((), device=sim.device) if temperature is None else temperature.float()
    if valid is None:
        return _symmetric_ce(sim * torch.softmax(sim / tem, dim=1) * sim.shape[0])
    col_bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    n_valid = valid.float().sum()
    return _symmetric_ce(sim * torch.softmax(sim / tem + col_bias[None, :], dim=1) * n_valid,
                         valid)
