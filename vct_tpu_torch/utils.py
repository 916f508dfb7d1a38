"""Small host-side utilities (port of ``vct_tpu/utils.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int = 666) -> None:
    """Seed the host RNGs and torch's default generators (reference
    ``setup_seed``, ``utils.py:115-123``; 666 at ``train.py:308``). Weight
    initialisation in this package takes an explicit ``torch.Generator``
    instead of relying on this global state."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
