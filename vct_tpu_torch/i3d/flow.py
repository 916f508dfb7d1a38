"""Host-side optical flow for the I3D flow stream (a copy of
``vct_tpu/i3d/flow.py``; numpy and OpenCV only).

The Kinetics I3D flow stream expects per-pixel displacement fields,
truncated to [-20, 20] px and rescaled to [-1, 1] (the kinetics-i3d
preprocessing contract the ``video_features`` dependency follows). Flow is
computed after the geometric transform (resize-short-256, center-crop-224)
so displacement magnitudes live in the crop's pixel space.

The estimator is Farnebäck: OpenCV without its contrib modules
(``cv2.optflow``) has neither TV-L1 nor PWC-Net. It has the same contract
(dense [H, W, 2] displacement in pixels) with a different smoothness prior,
so absolute flow-stream features differ from TV-L1-trained expectations.
"""

from __future__ import annotations

import numpy as np

from vct_tpu_torch.i3d.model import resize_center_crop

FLOW_TRUNCATE = 20.0  # kinetics-i3d: truncate flow to [-20, 20] px, /20


def estimate_flow(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [T, H, W, 3] -> float32 [T-1, H, W, 2] raw per-pixel
    displacement (Farnebäck on grayscale; see module docstring for the
    TV-L1 substitution note). Needs T >= 2."""
    import cv2

    if len(frames) < 2:
        raise ValueError("optical flow needs at least 2 frames")
    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
    out = np.empty((len(frames) - 1, *grays[0].shape, 2), np.float32)
    for i in range(len(grays) - 1):
        out[i] = cv2.calcOpticalFlowFarneback(
            grays[i], grays[i + 1], None,
            0.5, 3, 15, 3, 5, 1.2, 0,
        )
    return out


def flow_from_cropped(cropped: np.ndarray) -> np.ndarray:
    """Cropped uint8 frames [T, 224, 224, 3] -> float32 scaled flow
    [max(T-1, 1), 224, 224, 2] in [-1, 1]: flow estimation, +/-20 px
    truncation, /20 rescale. Tolerates T == 1 by duplicating the frame
    (a near-zero flow field — Farneback leaves ~0.05 px numerical residue
    on identical frames) — the degenerate-video tolerance lives HERE so no
    flow consumer can forget it and crash on 1-frame videos."""
    if len(cropped) < 2:
        cropped = np.concatenate([cropped, cropped])
    flow = estimate_flow(cropped)
    return np.clip(flow, -FLOW_TRUNCATE, FLOW_TRUNCATE) / FLOW_TRUNCATE


def preprocess_i3d_flow(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [T, H, W, 3] -> float32 [max(T-1, 1), 224, 224, 2] in
    [-1, 1]: geometric transform then ``flow_from_cropped`` — ready for
    ``i3d_stacks`` (C=2) and the flow-weight ``I3DTower``."""
    return flow_from_cropped(resize_center_crop(frames))
