"""Video-text joint-embedding matching head (port of
``vct_tpu/models/matching.py``; the reference's ``model/Matching.py``).

An optional ``v_proj`` Linear when the video and text widths differ
(``Matching.py:21``), then a CLIP symmetric contrastive loss (CSL or
CSL_WDS). The learnable temperature lives in ``loss_fn``, as in the
reference's state dict (``matching.loss_fn.temperature``); a fixed
temperature comes from the config.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vct_tpu_torch.models.layers import linear
from vct_tpu_torch.models.losses import clip_symmetric_loss, clip_symmetric_loss_wds

LOSSES = {"CSL": clip_symmetric_loss, "CSL_WDS": clip_symmetric_loss_wds}


class ContrastiveLoss(nn.Module):
    """The contrastive loss of (video, text) features, with the learnable
    temperature (initialised to 1) when ``enable_tem``."""

    def __init__(self, loss: str = "CSL", enable_tem: bool = False,
                 fixed_tem: Optional[float] = None, *, device=None):
        super().__init__()
        if loss not in LOSSES:
            raise ValueError(f"unsupported matching loss: {loss}")
        self.fn, self.fixed_tem = LOSSES[loss], fixed_tem
        self.temperature = nn.Parameter(torch.ones(1, device=device)) if enable_tem else None

    def forward(self, video: torch.Tensor, text: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        tem = self.temperature
        if tem is None and self.fixed_tem is not None:
            tem = torch.tensor([self.fixed_tem], device=video.device)
        return self.fn(video, text, tem, valid)


class Matching(nn.Module):
    def __init__(self, video_dim: int, text_dim: int, loss: str = "CSL",
                 enable_tem: bool = False, fixed_tem: Optional[float] = None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.v_proj = nn.Linear(video_dim, text_dim, device=device) \
            if video_dim != text_dim else None
        self.loss_fn = ContrastiveLoss(loss, enable_tem, fixed_tem, device=device)

    def forward(self, text_feat: torch.Tensor, vid_feat: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``valid`` [B] bool restricts the contrastive batch to real rows:
        collate filler rows (copies of row 0) would otherwise be false
        negatives of their own positive pair."""
        if self.v_proj is not None:
            vid_feat = linear(vid_feat, self.v_proj.weight, self.v_proj.bias, self.dtype)
        return self.loss_fn(vid_feat, text_feat, valid)
