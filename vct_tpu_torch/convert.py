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
    and the ``model`` entry of a train-state checkpoint
    (``train.state.save_checkpoint``), and stripping the DDP ``module.``
    prefix."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    elif isinstance(raw, dict) and "optimizer" in raw and isinstance(raw.get("model"), dict):
        raw = raw["model"]
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


# ---------------------------------------------------------------------------
# special importers (reference MMT4Caption.py:213-283)
# ---------------------------------------------------------------------------


def import_bert_embeddings(model: nn.Module,
                           bert_state: Dict[str, Any]) -> Dict[str, List[str]]:
    """``load_embedding_from_bert`` (``MMT4Caption.py:213-220``): BERT's word
    embeddings -> ``tgt_to_emb``, its position embeddings -> the decoder's
    ``positional_encoding`` buffer (a 512-row table fills the first rows).
    In place -> the ``load_state_dict_into`` report of the two keys."""
    return load_state_dict_into(model, {
        "cap_decoder.tgt_to_emb.weight": bert_state["embeddings.word_embeddings.weight"],
        "cap_decoder.positional_encoding.pos_embedding":
            bert_state["embeddings.position_embeddings.weight"],
    })


def univl_to_reference_keys(univl: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """UniVL decoder checkpoint -> the reference's ``cap_decoder`` keys, by
    the table at ``MMT4Caption.py:226-281`` (separate q/k/v weights are
    concatenated into the packed ``in_proj`` layout)."""
    src = {k: torch.as_tensor(np.asarray(v)) for k, v in univl.items()}
    out: Dict[str, torch.Tensor] = {}
    n_layers = 0
    while f"decoder.decoder.layer.{n_layers}.slf_attn.att.query.weight" in src:
        n_layers += 1
    for l in range(n_layers):
        theirs_l, ours_l = f"decoder.decoder.layer.{l}", f"cap_decoder.decoder.layers.{l}"
        for wb in ("weight", "bias"):
            for ours, theirs in (("self_attn", "slf_attn"), ("multihead_attn", "enc_attn")):
                out[f"{ours_l}.{ours}.in_proj_{wb}"] = torch.cat(
                    [src[f"{theirs_l}.{theirs}.att.{part}.{wb}"]
                     for part in ("query", "key", "value")], dim=0)
                out[f"{ours_l}.{ours}.out_proj.{wb}"] = src[
                    f"{theirs_l}.{theirs}.output.dense.{wb}"]
            out[f"{ours_l}.norm1.{wb}"] = src[f"{theirs_l}.slf_attn.output.LayerNorm.{wb}"]
            out[f"{ours_l}.norm2.{wb}"] = src[f"{theirs_l}.enc_attn.output.LayerNorm.{wb}"]
            out[f"{ours_l}.linear1.{wb}"] = src[f"{theirs_l}.intermediate.dense.{wb}"]
            out[f"{ours_l}.linear2.{wb}"] = src[f"{theirs_l}.output.dense.{wb}"]
            out[f"{ours_l}.norm3.{wb}"] = src[f"{theirs_l}.output.LayerNorm.{wb}"]
    for wb in ("weight", "bias"):
        out[f"cap_decoder.decoder.norm.{wb}"] = src[f"decoder.embeddings.LayerNorm.{wb}"]
    out["cap_decoder.generator.weight"] = src["decoder.classifier.cls.predictions.decoder.weight"]
    out["cap_decoder.generator.bias"] = src["decoder.classifier.cls.predictions.bias"]
    out["cap_decoder.tgt_to_emb.weight"] = src["decoder.embeddings.word_embeddings.weight"]
    out["cap_decoder.positional_encoding.pos_embedding"] = src[
        "decoder.embeddings.position_embeddings.weight"]
    return out


def import_univl_decoder(model: nn.Module, univl: Dict[str, Any]) -> Dict[str, List[str]]:
    """The UniVL decoder into ``model`` in place (``MMT4Caption.py:222-283``)
    -> the ``load_state_dict_into`` report: nothing unexpected, and only keys
    outside ``cap_decoder`` missing."""
    return load_state_dict_into(model, univl_to_reference_keys(univl))
