"""OpenAI / HF CLIP checkpoints -> the port's CLIP towers (port of
``vct_tpu/clip/convert.py``).

The reference never ships CLIP weights in its checkpoints: the towers live in
the ``video_features`` submodule / ``openai/clip`` dependency. These loaders
take the same published ViT-B/32 weights from either

* an OpenAI-format state dict (``clip.load('ViT-B/32')`` -> keys
  ``visual.conv1.weight`` ...), or
* a HuggingFace ``CLIPVisionModelWithProjection`` state dict (keys
  ``vision_model.embeddings.patch_embedding.weight`` ...),

and give a state dict that ``CLIPVisionTower.load_state_dict`` takes
strictly. ``clip_state_dict_from_jax`` / ``clip_text_state_dict_from_jax``
carry the ``vct_tpu`` towers' Flax params across.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def load_clip_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """CLIP weights from ``.npz`` (numpy archive) or a torch ``.pt``/``.bin``
    state dict: the one loading branch shared by the vision (``-v`` CLI,
    server) and text (matching task) paths."""
    if path.endswith(".npz"):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in np.load(path).items()}
    from vct_tpu_torch.convert import load_torch_state_dict

    return load_torch_state_dict(path)


# HF encoder-layer modules -> OpenAI resblock modules (q/k/v are packed apart)
_HF_LAYER_MODULES = {
    "layer_norm1": "ln_1", "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
    "mlp.fc2": "mlp.c_proj", "self_attn.out_proj": "attn.out_proj",
}
_HF_QKV = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")


def hf_to_openai_keys(sd: Dict, hf_root: str, prefix: str, renames: Dict[str, str],
                      projection: Tuple[str, str]) -> Dict[str, torch.Tensor]:
    """An HF CLIP tower's state dict (``hf_root`` ``vision_model`` or
    ``text_model``) -> OpenAI's keys, the layers' under ``prefix``:
    ``renames`` for the keys outside the layers, ``projection`` (HF key,
    OpenAI key) for the projection, transposed from HF's Linear [out, width]
    to [width, out], and each layer's separate q/k/v packed into
    ``attn.in_proj_*``."""
    out: Dict[str, torch.Tensor] = {}
    qkv: Dict[tuple, Dict[str, torch.Tensor]] = {}
    layers = f"{hf_root}.encoder.layers."
    for k, v in sd.items():
        v = torch.as_tensor(np.asarray(v))
        if k in renames:
            out[renames[k]] = v
        elif k == projection[0]:
            out[projection[1]] = v.T.contiguous()
        elif k.startswith(layers):
            i, rest = k[len(layers):].split(".", 1)
            module, leaf = rest.rsplit(".", 1)
            p = f"{prefix}transformer.resblocks.{i}"
            if module in _HF_LAYER_MODULES:
                out[f"{p}.{_HF_LAYER_MODULES[module]}.{leaf}"] = v
            elif module in _HF_QKV:
                qkv.setdefault((p, leaf), {})[module] = v
    for (p, leaf), parts in qkv.items():
        out[f"{p}.attn.in_proj_{leaf}"] = torch.cat([parts[m] for m in _HF_QKV], dim=0)
    return out


def _hf_to_openai(sd: Dict) -> Dict[str, torch.Tensor]:
    """Rename HF CLIPVisionModelWithProjection keys to OpenAI-format keys."""
    return hf_to_openai_keys(sd, "vision_model", "visual.", {
        "vision_model.embeddings.patch_embedding.weight": "visual.conv1.weight",
        "vision_model.embeddings.class_embedding": "visual.class_embedding",
        "vision_model.embeddings.position_embedding.weight": "visual.positional_embedding",
        "vision_model.pre_layrnorm.weight": "visual.ln_pre.weight",  # (sic) HF typo
        "vision_model.pre_layrnorm.bias": "visual.ln_pre.bias",
        "vision_model.post_layernorm.weight": "visual.ln_post.weight",
        "vision_model.post_layernorm.bias": "visual.ln_post.bias",
    }, projection=("visual_projection.weight", "visual.proj"))


def first_blocks(sd: Dict, layers: Optional[int]) -> Dict[str, torch.Tensor]:
    """A tower's state dict (keys without a prefix) as float32 tensors, the
    blocks past the first ``layers`` left out (all kept when None)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()
            if layers is None or not k.startswith("transformer.resblocks.")
            or int(k.split(".")[2]) < layers}


def convert_clip(sd: Dict, layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """OpenAI- or HF-format state dict (tensors or numpy) -> the vision
    tower's state dict (OpenAI's ``visual.*`` keys without the prefix,
    float32), the first ``layers`` blocks (all when None)."""
    if "visual.conv1.weight" not in sd and any(k.startswith("vision_model.") for k in sd):
        sd = _hf_to_openai(sd)
    return first_blocks({k[len("visual."):]: v for k, v in sd.items()
                         if k.startswith("visual.")}, layers)


# ---------------------------------------------------------------------------
# the vct_tpu towers' Flax params -> the port's state dicts
# ---------------------------------------------------------------------------


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.tensor(a.T if transpose else a)  # a copy: JAX arrays are read-only


def _blocks_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    i = 0
    while f"resblocks_{i}" in params:
        b, p = params[f"resblocks_{i}"], f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            out[f"{p}.{ln}.weight"] = _t(b[ln]["scale"])
            out[f"{p}.{ln}.bias"] = _t(b[ln]["bias"])
        out[f"{p}.attn.in_proj_weight"] = _t(b["attn"]["in_proj_kernel"], True)
        out[f"{p}.attn.in_proj_bias"] = _t(b["attn"]["in_proj_bias"])
        out[f"{p}.attn.out_proj.weight"] = _t(b["attn"]["out_proj"]["kernel"], True)
        out[f"{p}.attn.out_proj.bias"] = _t(b["attn"]["out_proj"]["bias"])
        for ours, theirs in (("c_fc", "mlp_fc"), ("c_proj", "mlp_proj")):
            out[f"{p}.mlp.{ours}.weight"] = _t(b[theirs]["kernel"], True)
            out[f"{p}.mlp.{ours}.bias"] = _t(b[theirs]["bias"])
        i += 1
    return out


def clip_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``vct_tpu.clip.CLIPVisionTower`` params (array leaves) -> the port's
    vision tower state dict: the inverse of ``vct_tpu``'s ``_from_openai``
    without the ``visual.`` prefix."""
    kernel = np.asarray(params["patch_kernel"], np.float32)  # [p*p*3, width]
    patch = math.isqrt(kernel.shape[0] // 3)
    conv = kernel.reshape(patch, patch, 3, kernel.shape[1]).transpose(3, 2, 0, 1)
    out = {
        "conv1.weight": _t(conv),
        "class_embedding": _t(params["class_embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "proj": _t(params["proj"]),
    }
    for ln in ("ln_pre", "ln_post"):
        out[f"{ln}.weight"] = _t(params[ln]["scale"])
        out[f"{ln}.bias"] = _t(params[ln]["bias"])
    out.update(_blocks_from_jax(params))
    return out


def clip_text_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``vct_tpu.clip.CLIPTextTower`` params -> the port's text tower state
    dict (the inverse of ``vct_tpu.clip.text.convert_clip_text``)."""
    out = {
        "token_embedding.weight": _t(params["token_embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "ln_final.weight": _t(params["ln_final"]["scale"]),
        "ln_final.bias": _t(params["ln_final"]["bias"]),
        "text_projection": _t(params["text_projection"]),
    }
    out.update(_blocks_from_jax(params))
    return out
