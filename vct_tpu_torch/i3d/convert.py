"""Torch InceptionI3d checkpoints -> the port's ``I3DTower`` (port of
``vct_tpu/i3d/convert.py``).

Source layout: the standard Kinetics InceptionI3d state dict of the
piergiaj/pytorch-i3d port of the DeepMind weights, which the reference's
``video_features`` dependency wraps. Keys look like::

    Conv3d_1a_7x7.conv3d.weight                       [out, in, kt, kh, kw]
    Conv3d_1a_7x7.bn.{weight,bias,running_mean,running_var}
    Mixed_3b.b0.conv3d.weight    Mixed_3b.b1a...b1b...b2a...b2b...b3b...
    logits.conv3d.{weight,bias}

``convert_i3d`` keeps each conv weight under its key and in its layout and
folds each eval-mode BatchNorm into the unit's ``scale`` / ``offset`` with
the reference's float32 formula (``scale = gamma / sqrt(running_var +
1e-3)``, ``offset = beta - running_mean * scale``), so the result loads into
the tower with ``load_state_dict(strict=True)`` and holds the reference's
bits. ``i3d_state_dict_from_jax`` carries ``vct_tpu``'s Flax parameters
across for the tests.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vct_tpu_torch.i3d.model import INCEPTION_CHANNELS

BN_EPS = 1e-3

_STEM = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")
_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


def load_i3d_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.pt``/``.pth`` torch state dict (or ``.npz``) to numpy."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _unit_names(with_logits: bool):
    names = list(_STEM) + [f"{name}.{b}" for name, _ in INCEPTION_CHANNELS for b in _BRANCHES]
    return names + ["logits"] if with_logits else names


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a copy: JAX arrays are read-only


def convert_i3d(sd: Dict[str, Any], with_logits: bool = False) -> Dict[str, torch.Tensor]:
    """Torch InceptionI3d state dict (numpy arrays or tensors) -> the port
    tower's state dict, float32, BatchNorm folded; the Kinetics head's conv
    and bias with ``with_logits``."""
    out: Dict[str, torch.Tensor] = {}
    for prefix in _unit_names(with_logits):
        out[f"{prefix}.conv3d.weight"] = _t(sd[f"{prefix}.conv3d.weight"])
        if f"{prefix}.conv3d.bias" in sd:
            out[f"{prefix}.conv3d.bias"] = _t(sd[f"{prefix}.conv3d.bias"])
        if prefix == "logits":
            continue
        gamma = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
        beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
        mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
        var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
        scale = gamma / np.sqrt(var + BN_EPS)
        out[f"{prefix}.scale"] = _t(scale)
        out[f"{prefix}.offset"] = _t(beta - mean * scale)
    return out


def unit_state_dict_from_jax(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One ``vct_tpu`` ``Unit3D``'s params -> the port unit's state dict: the
    conv kernel back from Flax's ``[kt, kh, kw, I, O]`` to ``[O, I, kt, kh,
    kw]``, its bias, ``scale`` / ``offset`` as they are."""
    out = {"conv3d.weight": _t(np.transpose(np.asarray(p["conv"]["kernel"]), (4, 3, 0, 1, 2)))}
    if "bias" in p["conv"]:
        out["conv3d.bias"] = _t(p["conv"]["bias"])
    out.update({name: _t(p[name]) for name in ("scale", "offset") if name in p})
    return out


def i3d_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``vct_tpu.i3d.I3DTower`` params (array leaves) -> the port tower's
    state dict (the inverse of ``vct_tpu``'s ``convert_i3d``)."""
    out: Dict[str, torch.Tensor] = {}
    for prefix in _unit_names("logits" in params):
        p = params
        for part in prefix.split("."):
            p = p[part]
        out.update({f"{prefix}.{k}": v for k, v in unit_state_dict_from_jax(p).items()})
    return out
