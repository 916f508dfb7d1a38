"""Seeded weights under the reference's ``state_dict`` key names.

The whole model is drawn on the run's device by one ``torch.randn`` call of
one generator seeded from ``--seed``, scaled per tensor and held in the type
the program keeps them in: bfloat16, the type the MSVD recipe serves in, or
float32, the master weights a training run updates. (Master weights rounded
to bf16 would sit on bf16's grid, where the first Adam steps at the recipe's
learning rate leave every weight of magnitude 1/32 or more where the bf16
forward reads it.) The program takes these tensors through its own loader;
the reference takes the same values in float32 (exact both ways).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def dims_of(config: dict) -> Dict[str, int]:
    """The sizes the reference needs, read from a configuration file."""
    model = config["model"]
    enc, dec = model["video_encoder"], model["caption_decoder"]
    return {
        "embed_dim": int(model["embed_dim"]),
        "feat_dim": int(model["modal_shape"][0]),
        "encoder_layers": int(enc["layer"]),
        "encoder_heads": int(enc["nhead"]),
        "encoder_ff": int(enc["feedforward"]),
        "decoder_layers": int(dec["layer"]),
        "decoder_heads": int(dec["nhead"]),
        "decoder_ff": int(dec["feedforward"]),
        "vocab": int(config["vocab_size"]),
        "text_dim": int(config["text_dim"]),
        "pad_id": 0,
        "sce_alpha": float(dec["sce_loss_alpha"]),
        "max_frames": int(config["tpu"]["max_frames"]),
        "max_caption_len": int(config["tpu"]["max_caption_len"]),
        "max_length": int(config["test"]["max_length"]),
    }


def spec(d: Dict[str, int]) -> Spec:
    """(key, shape, kind) of every weight of the one-modality MME caption
    model with a matching head."""
    e, out = d["embed_dim"], []

    def linear(name, n_out, n_in):
        out.append((name + ".weight", (n_out, n_in), "matrix"))
        out.append((name + ".bias", (n_out,), "bias"))

    def norm(name):
        out.append((name + ".weight", (e,), "norm_weight"))
        out.append((name + ".bias", (e,), "norm_bias"))

    def attn(name):
        out.append((name + ".in_proj_weight", (3 * e, e), "matrix"))
        out.append((name + ".in_proj_bias", (3 * e,), "bias"))
        linear(name + ".out_proj", e, e)

    linear("video_encoder.unify.0", e, d["feat_dim"])
    for i in range(d["encoder_layers"]):
        p = f"video_encoder.transformer_encoder.layers.{i}"
        attn(p + ".self_attn")
        linear(p + ".linear1", d["encoder_ff"], e)
        linear(p + ".linear2", e, d["encoder_ff"])
        norm(p + ".norm1")
        norm(p + ".norm2")
    norm("video_encoder.transformer_encoder.norm")
    for i in range(d["decoder_layers"]):
        p = f"cap_decoder.decoder.layers.{i}"
        attn(p + ".self_attn")
        attn(p + ".multihead_attn")
        linear(p + ".linear1", d["decoder_ff"], e)
        linear(p + ".linear2", e, d["decoder_ff"])
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{p}.{n}")
    norm("cap_decoder.decoder.norm")
    out.append(("cap_decoder.generator.weight", (d["vocab"], e), "generator"))
    out.append(("cap_decoder.generator.bias", (d["vocab"],), "bias"))
    out.append(("cap_decoder.tgt_to_emb.weight", (d["vocab"], e), "embedding"))
    linear("matching.v_proj", d["text_dim"], e)
    return out


def _std(kind: str, shape) -> Tuple[float, float]:
    """(mean, std) of each kind: Xavier-scaled matrices, a LeCun-scaled LM
    head, unit-normal embeddings; small non-zero biases and LayerNorm
    parameters, so that a path that drops one shows."""
    if kind == "matrix":
        return 0.0, math.sqrt(2.0 / (shape[0] + shape[1]))
    if kind == "generator":
        return 0.0, 1.0 / math.sqrt(shape[1])
    if kind == "embedding":
        return 0.0, 1.0
    if kind == "bias":
        return 0.0, 0.02
    if kind == "norm_weight":
        return 1.0, 0.1
    return 0.0, 0.1  # norm_bias


def make_weights(d: Dict[str, int], seed: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{key: ``dtype`` tensor on ``device``}, all views of one buffer."""
    entries = spec(d)
    sizes = [math.prod(s) for _, s, _ in entries]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    mean = torch.empty_like(flat)
    std = torch.empty_like(flat)
    at = 0
    for (_, shape, kind), n in zip(entries, sizes):
        m, s = _std(kind, shape)
        mean[at:at + n], std[at:at + n] = m, s
        at += n
    flat = (flat * std + mean).to(dtype)
    del mean, std
    out, at = {}, 0
    for (key, shape, _), n in zip(entries, sizes):
        out[key] = flat[at:at + n].view(shape)
        at += n
    return out


def float32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's copy: the same values in float32."""
    return {k: v.float() for k, v in weights.items()}
