"""CLIP ViT-B/32 image tower (port of ``vct_tpu/clip/vision.py``).

Architecture (OpenAI CLIP visual, ViT-B/32): 32x32 non-overlapping patch
embedding (a matmul with the ``conv1`` weight), class token, learned
positional embedding, pre-norm transformer (width 768, 12 layers, 12 heads,
QuickGELU), ``ln_post`` on the class token, projection to the 512-d joint
space: the embedding the CLIP4Clip features of the shipped configs hold.

The modules carry the keys of OpenAI's ``visual.*`` state dict without the
prefix (``conv1``, ``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.N.{ln_1, attn, ln_2, mlp.c_fc, mlp.c_proj}``,
``ln_post``, ``proj``), so ``vct_tpu_torch.clip.convert.convert_clip`` of an
OpenAI or HF checkpoint loads with ``load_state_dict(strict=True)``. The tower
takes NHWC pixels, as the reference's does, and runs in float32 unless asked
otherwise. The towers attend over 50 (vision) and 77 (text) tokens with their
own products; no attention kernel runs in them, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vct_tpu_torch.models.layers import layer_norm, linear

IMAGE_SIZE = 224
# CLIP preprocessing constants (OpenAI _transform)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Packed-QKV multi-head attention (OpenAI's ``nn.MultiheadAttention``
    keys). ``mask`` is an optional additive [Tq, Tk] bias (the text tower's
    causal mask; images pass none). Logits and softmax in float32."""

    def __init__(self, width: int, heads: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, w = x.shape
        d = w // self.heads
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        q, k, v = (part.reshape(b, t, self.heads, d) for part in qkv.split(w, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
        if mask is not None:
            logits = logits + mask.float()
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(self.dtype), v).reshape(b, t, w)
        return linear(out, self.out_proj.weight, self.out_proj.bias, self.dtype)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.c_fc = nn.Linear(width, 4 * width, device=device)
        self.c_proj = nn.Linear(4 * width, width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = quick_gelu(linear(x, self.c_fc.weight, self.c_fc.bias, self.dtype))
        return linear(x, self.c_proj.weight, self.c_proj.bias, self.dtype)


class CLIPBlock(nn.Module):
    """Pre-norm residual block: ``x + attn(ln_1(x))``, then ``+ mlp(ln_2(x))``."""

    def __init__(self, width: int, heads: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.attn = CLIPAttention(width, heads, dtype=dtype, device=device)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.mlp = CLIPMLP(width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1, self.dtype), mask)
        return x + self.mlp(layer_norm(x, self.ln_2, self.dtype))


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            CLIPBlock(width, heads, dtype=dtype, device=device) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


@torch.no_grad()
def init_clip_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` (drawn on the host and copied, so a
    seed gives the same weights on every device): unit LayerNorms, zero
    biases, N(0, 0.02) elsewhere."""
    for name, p in module.named_parameters():
        parent = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if isinstance(parent, nn.LayerNorm):
            val = torch.ones(p.shape) if name.endswith("weight") else torch.zeros(p.shape)
        elif "bias" in name.rsplit(".", 1)[-1]:
            val = torch.zeros(p.shape)
        else:
            val = torch.randn(p.shape, generator=generator) * 0.02
        p.copy_(val.to(p.dtype))
    return module


class CLIPVisionTower(nn.Module):
    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12, patch: int = 32,
                 out_dim: int = 512, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.width, self.layers, self.patch, self.dtype = width, layers, patch, dtype
        grid = IMAGE_SIZE // patch
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width, device=device))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5, device=device)
        self.transformer = CLIPTransformer(width, layers, heads, dtype=dtype, device=device)
        self.ln_post = nn.LayerNorm(width, eps=1e-5, device=device)
        self.proj = nn.Parameter(torch.empty(width, out_dim, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 224, 224, 3] (CLIP-normalized, NHWC) -> [B, out_dim]."""
        b, p, dt = images.shape[0], self.patch, self.dtype
        grid = IMAGE_SIZE // p
        # patchify as one matmul: [B, gh, p, gw, p, 3] -> [B, gh*gw, p*p*3],
        # the patches row-major over the grid, each flattened as (p_h, p_w, c)
        x = images.to(dt).reshape(b, grid, p, grid, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, grid * grid, p * p * 3)
        kernel = self.conv1.weight.permute(0, 2, 3, 1).reshape(self.width, p * p * 3)
        x = F.linear(x, kernel.to(dt))  # conv1 has no bias in CLIP
        cls = self.class_embedding.to(dt).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(layer_norm(x, self.ln_pre, dt))
        return layer_norm(x[:, 0], self.ln_post, dt) @ self.proj.to(dt)


def preprocess_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB frames [T, H, W, 3] -> CLIP-normalized [T, 224, 224, 3].

    Resize shorter side to 224 (bilinear) + center crop, then per-channel
    normalize: the OpenAI ``_transform`` pipeline (bicubic there; bilinear
    here via cv2, a sub-1e-2 pixel difference that does not move captions).
    """
    import cv2

    out = np.empty((len(frames), IMAGE_SIZE, IMAGE_SIZE, 3), np.float32)
    for i, f in enumerate(frames):
        h, w = f.shape[:2]
        scale = IMAGE_SIZE / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        r = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
        top, left = (nh - IMAGE_SIZE) // 2, (nw - IMAGE_SIZE) // 2
        crop = r[top : top + IMAGE_SIZE, left : left + IMAGE_SIZE]
        out[i] = crop.astype(np.float32) / 255.0
    return (out - CLIP_MEAN) / CLIP_STD
