"""Kinetics I3D (Inflated 3D Inception-v1) video tower (port of
``vct_tpu/i3d/model.py``): the I3D arm of the reference's feature extraction
(``--feat_type I3D`` of the reference's ``predict_video.py``).

Architecture (Kinetics-400 I3D): 7x7x7/2 stem, two conv blocks, nine
Inception modules (Mixed_3b..Mixed_5c) with max pools between stages; the
feature is the Mixed_5c output averaged by a (2, 7, 7) VALID pool and then a
mean over the remaining (T, H, W): one 1024-vector per 64-frame stack. The
optional Kinetics logits head is kept for conversion checks. The flow stream
is the same tower with a 2-channel stem.

What the port keeps of the reference's numerics:

* **TF-style SAME padding**, which is asymmetric: the stem pads 2 before and
  3 after on 64 x 224 x 224, ``MaxPool3d_2a`` (0, 1) at 112. Every conv and
  max pool pads explicitly with ``F.pad`` (zeros before a conv, -inf before a
  max pool, as ``nn.max_pool`` does), then runs unpadded.
* **Folded BatchNorm**: each ``Unit3D`` holds ``scale`` / ``offset``
  (``vct_tpu_torch.i3d.convert`` folds them as the reference's converter
  does) and applies ``x * scale + offset`` after a bias-free conv.
* **float32 convolutions**: cuDNN would run a float32 ``conv3d`` in TF32 by
  default (``torch.backends.cudnn.allow_tf32``); the tower switches TF32 off
  for its own forward, so its features have the reference's float32
  numerics whatever the caller's global switch says.

The tower takes NDHWC ``[B, T, H, W, C]``, as the reference's does, and
permutes to NCDHW inside. Conv weights keep torch's ``[O, I, kt, kh, kw]``
under the source checkpoint's ``<unit>.conv3d.weight`` keys. The host
preprocessing below is a copy of the reference's (numpy and cv2).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEATURE_DIM = 1024
NUM_KINETICS_CLASSES = 400
# video_features' I3D clip geometry: 64-frame stacks, stride 64, 224x224.
STACK_SIZE = 64
STEP_SIZE = 64
IMAGE_SIZE = 224

# (name, [b0, b1a, b1b, b2a, b2b, b3b]) output channels per Inception branch.
# Standard Inception-v1 table; concat order b0 | b1b | b2b | b3b.
INCEPTION_CHANNELS: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)


def same_pad(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """Pad NCDHW ``x`` as XLA's ``padding="SAME"`` does: each spatial axis to
    ``ceil(n / stride)`` windows, the odd pad after (``lax.padtype_to_pads``)."""
    pads = []
    for n, k, s in zip(x.shape[2:], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    if not any(lo or hi for lo, hi in pads):
        return x
    return F.pad(x, [p for pair in reversed(pads) for p in pair], value=value)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int],
                  stride: Sequence[int]) -> torch.Tensor:
    """``nn.max_pool(..., padding="SAME")`` on NCDHW: -inf padding."""
    return F.max_pool3d(same_pad(x, kernel, stride, float("-inf")), tuple(kernel),
                        tuple(stride))


class Unit3D(nn.Module):
    """Conv3D + folded BatchNorm affine + ReLU, the I3D building block. The
    classifier head is ``use_bn=False, use_bias=True, activation=False``."""

    def __init__(self, in_channels: int, features: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), *, use_bn: bool = True,
                 use_bias: bool = False, activation: bool = True, device=None):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(in_channels, features, self.kernel, self.stride, padding=0,
                                bias=use_bias, device=device)
        self.use_bn = use_bn
        if use_bn:
            self.scale = nn.Parameter(torch.ones(features, device=device))
            self.offset = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x NCDHW -> NCDHW."""
        x = self.conv3d(same_pad(x, self.kernel, self.stride))
        if self.use_bn:
            x = x * self.scale[:, None, None, None] + self.offset[:, None, None, None]
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    """Four-branch Inception block: 1x1 | 1x1->3x3 | 1x1->3x3 | pool->1x1,
    concatenated b0 | b1b | b2b | b3b along the channels."""

    def __init__(self, in_channels: int, channels: Sequence[int], *, device=None):
        super().__init__()
        c, k3 = channels, (3, 3, 3)
        self.out_channels = c[0] + c[2] + c[4] + c[5]
        self.b0 = Unit3D(in_channels, c[0], device=device)
        self.b1a = Unit3D(in_channels, c[1], device=device)
        self.b1b = Unit3D(c[1], c[2], k3, device=device)
        self.b2a = Unit3D(in_channels, c[3], device=device)
        self.b2b = Unit3D(c[3], c[4], k3, device=device)
        self.b3b = Unit3D(in_channels, c[5], device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


class I3DTower(nn.Module):
    """Kinetics I3D backbone: ``[B, T, H, W, C]`` (T=64, H=W=224, C=3 RGB or 2
    flow, values in [-1, 1]) -> ``[B, 1024]`` clip features, or the Kinetics
    logits ``[B, num_classes]`` with ``with_logits``. The parameters' dtype is
    the compute dtype (float32; ``.double()`` for a float64 reference)."""

    def __init__(self, in_channels: int = 3, *, with_logits: bool = False,
                 num_classes: int = NUM_KINETICS_CLASSES, device=None):
        super().__init__()
        self.with_logits = with_logits
        self.Conv3d_1a_7x7 = Unit3D(in_channels, 64, (7, 7, 7), (2, 2, 2), device=device)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, device=device)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), device=device)
        cin = 192
        for name, ch in INCEPTION_CHANNELS:
            block = InceptionModule(cin, ch, device=device)
            self.add_module(name, block)
            cin = block.out_channels
        if with_logits:
            self.logits = Unit3D(cin, num_classes, use_bn=False, use_bias=True,
                                 activation=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=True, allow_tf32=False):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.Conv3d_1a_7x7.conv3d.weight.dtype).permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
        for name, _ in INCEPTION_CHANNELS:
            if name == "Mixed_4b":
                x = max_pool_same(x, (3, 3, 3), (2, 2, 2))  # MaxPool3d_4a_3x3
            elif name == "Mixed_5b":
                x = max_pool_same(x, (2, 2, 2), (2, 2, 2))  # MaxPool3d_5a_2x2
            x = getattr(self, name)(x)
        # two stages, as the reference: a (2, 7, 7) VALID average pool, then
        # the mean over what remains (the edge time steps weigh half)
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        if self.with_logits:
            x = self.logits(x)
        return x.mean(dim=(2, 3, 4))


@torch.no_grad()
def stack_features(tower: I3DTower, frames: np.ndarray) -> np.ndarray:
    """Preprocessed frames [T, 224, 224, C] -> float32 [n_stacks, 1024]: the
    ``i3d_stacks`` clips through ``tower`` on its device, one clip per call
    (the stack count varies by video; one clip bounds the activations)."""
    clips = torch.from_numpy(i3d_stacks(frames))
    device = tower.Conv3d_1a_7x7.conv3d.weight.device
    return np.concatenate([tower(clip[None].to(device)).float().cpu().numpy()
                           for clip in clips])


def resize_center_crop(frames: np.ndarray) -> np.ndarray:
    """uint8 [T, H, W, 3] -> uint8 [T, 224, 224, 3]: resize short side to
    256, center-crop 224 (the I3D geometric transform, shared by the RGB
    scaling below and the flow arm in ``i3d.flow``). Host-side; cv2 only
    imported here."""
    import cv2

    # buffer keeps the input dtype: cv2.resize preserves it, and forcing
    # uint8 would silently truncate/wrap float-frame callers
    out = np.empty((len(frames), IMAGE_SIZE, IMAGE_SIZE, 3), frames.dtype)
    for i, f in enumerate(frames):
        h, w = f.shape[:2]
        s = 256.0 / min(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
        r = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
        top, left = (nh - IMAGE_SIZE) // 2, (nw - IMAGE_SIZE) // 2
        out[i] = r[top:top + IMAGE_SIZE, left:left + IMAGE_SIZE]
    return out


def scale_i3d_frames(cropped: np.ndarray) -> np.ndarray:
    """Cropped uint8 [T, 224, 224, 3] -> float32 in [-1, 1]: the I3D RGB
    scaling, apart from the geometric transform so that one-pass extractors
    crop once and feed both streams."""
    return cropped.astype(np.float32) / 127.5 - 1.0


def preprocess_i3d_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [T, H, W, 3] -> float32 [T, 224, 224, 3] in [-1, 1]
    (video_features' I3D transform: resize short side to 256, center-crop
    224, scale to [-1, 1])."""
    return scale_i3d_frames(resize_center_crop(frames))


def i3d_stacks(frames: np.ndarray, stack: int = STACK_SIZE,
               step: int = STEP_SIZE) -> np.ndarray:
    """[T, H, W, C] frames -> [n_stacks, stack, H, W, C] clips (the
    video_features stacking: consecutive ``stack``-frame windows at stride
    ``step``; a video shorter than one stack is looped to fill it, so every
    video yields at least one clip)."""
    t = len(frames)
    if t == 0:
        raise ValueError("no frames to stack")
    if t < stack:
        reps = -(-stack // t)
        frames = np.concatenate([frames] * reps)[:stack]
        t = stack
    n = 1 + (t - stack) // step
    return np.stack([frames[i * step:i * step + stack] for i in range(n)])
