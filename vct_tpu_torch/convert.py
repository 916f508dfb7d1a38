"""Weights between the reference formats and the port (port of
``vct_tpu/convert.py``).

The port's modules carry the reference ``state_dict`` key names
(``cap_decoder.decoder.layers.0.self_attn.in_proj_weight``,
``video_encoder.unify.0.weight``, ...), so a reference ``.pth`` loads
directly. ``state_dict_from_jax`` carries a ``vct_tpu`` variable tree
(``{'params', 'buffers'}`` as numpy arrays) across with the same key and
transpose rules ``vct_tpu.convert`` applies in the other direction. Loads are
lenient like every reference load site (``strict=False``): missing and
unexpected keys are reported, never raised.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# flax module-path element -> torch module-path element
_MODULE_RULES = [
    (re.compile(r"^(layers|unify|transformer_encoders|trans_enc_layers)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^pre_norm$"), "norm"),  # MME do_norm LayerNorm
]

# flax leaf name -> (torch leaf name, needs a 2-D transpose)
_LEAF_RULES = {
    "kernel": ("weight", True),
    "scale": ("weight", False),  # LayerNorm
    "bias": ("bias", False),
    "in_proj_kernel": ("in_proj_weight", True),
    "in_proj_bias": ("in_proj_bias", False),
    "weight_ih": ("weight_ih_l0", True),
    "weight_hh": ("weight_hh_l0", True),
    "bias_ih": ("bias_ih_l0", False),
    "bias_hh": ("bias_hh_l0", False),
    "pos_embedding": ("pos_embedding", False),
}


def jax_path_to_key(path: Tuple[str, ...]) -> Optional[Tuple[str, bool]]:
    """A ``vct_tpu`` variable path -> (reference state_dict key, transpose)."""
    parts: List[str] = []
    reverse_gru = False
    for p in path[:-1]:
        if p == "agg_reverse":  # torch biGRU keeps reverse weights on one module
            parts.append("agg")
            reverse_gru = True
            continue
        if p == "modal_emb" and path[-1] == "embedding":
            parts.append("modal_emb.modal_emb")
            continue
        if p == "temp_emb" and path[-1] == "embedding":
            parts.append("temp_emb.embedding")
            continue
        for rx, repl in _MODULE_RULES:
            if rx.match(p):
                p = rx.sub(repl, p)
                break
        parts.append(p)

    leaf = path[-1]
    if leaf == "tgt_to_emb":
        parts.append("tgt_to_emb")
        leaf_name, transpose = "weight", False
    elif leaf == "embedding":
        leaf_name, transpose = "weight", False
    elif leaf == "temperature":
        parts.append("loss_fn")
        leaf_name, transpose = "temperature", False
    elif leaf in _LEAF_RULES:
        leaf_name, transpose = _LEAF_RULES[leaf]
    else:
        return None
    if reverse_gru:
        leaf_name += "_reverse"
    return ".".join(parts + [leaf_name]), transpose


def _walk(tree: Any, path: Tuple[str, ...] = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``vct_tpu`` variables ({'params', 'buffers'}, leaves array-like) ->
    the port's ``state_dict`` (float32 CPU tensors, torch layouts)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "buffers"):
        for path, leaf in _walk(variables.get(collection, {})):
            translated = jax_path_to_key(path)
            if translated is None:
                raise KeyError(f"no state_dict key for {collection}/{'/'.join(path)}")
            key, transpose = translated
            arr = np.asarray(leaf, dtype=np.float32)
            if transpose:
                arr = arr.T
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` state_dict on the CPU, unwrapping ``{'state_dict': ...}``
    and stripping the DDP ``module.`` prefix."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in raw.items()}


@torch.no_grad()
def load_state_dict_into(model: nn.Module,
                         state_dict: Dict[str, Any]) -> Dict[str, List[str]]:
    """Copy ``state_dict`` into ``model`` in place -> {'missing',
    'unexpected'}. A shorter ``pos_embedding`` (512-row BERT/UniVL tables vs
    the 5000-row buffer) overwrites the first rows and keeps the rest."""
    own = model.state_dict()
    used = set()
    missing: List[str] = []
    for key, dst in own.items():
        if key not in state_dict:
            missing.append(key)
            continue
        src = torch.as_tensor(state_dict[key])
        if src.shape != dst.shape:
            if (key.endswith("pos_embedding") and src.ndim == dst.ndim == 2
                    and src.shape[1] == dst.shape[1] and src.shape[0] < dst.shape[0]):
                dst[: src.shape[0]].copy_(src.to(dst.dtype))
                used.add(key)
                continue
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(src.shape)} vs model {tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))
        used.add(key)
    unexpected = [k for k in state_dict if k not in used]
    return {"missing": missing, "unexpected": unexpected}
