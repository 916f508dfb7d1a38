"""The LFM2 caption LM's sizes, seeded weights, and operation and byte counts.

``dims_of`` reads a configuration file with a ``model.caption_lm`` section
(LFM2's keys at the file's top level, as the published ``config.json`` has
them) on top of the MME encoder's sizes
(``benchlib.weights.dims_of``). ``make_weights`` draws every weight of the
captioner, under the program's ``state_dict`` key names, in float32 on the
run's device from one generator seeded from ``--seed``, tensor by tensor
(the program takes them through its loader, the reference takes the same
tensors). The counts are the yardstick of the cell's ``lfm2.*`` metrics:
experts are counted as routed (``top_k`` of ``experts`` a token).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchlib import counts
from benchlib.weights import dims_of as encoder_dims

BF16, F32 = 2, 4
LM_KEYS = ("hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
           "layer_types", "num_attention_heads", "num_key_value_heads", "num_dense_layers",
           "num_experts", "num_experts_per_tok", "conv_L_cache", "conv_bias", "norm_eps",
           "rope_theta", "norm_topk_prob", "routed_scaling_factor", "use_expert_bias",
           "vocab_size")
EXPERT_BIAS_STD = 0.05


def dims_of(config: dict) -> dict:
    d = dict(encoder_dims(config))
    lm = {k: config[k] for k in LM_KEYS}
    hidden, heads = int(lm["hidden_size"]), int(lm["num_attention_heads"])
    d.update(hidden=hidden, heads=heads, kv_heads=int(lm["num_key_value_heads"]),
             head_dim=hidden // heads, dense_width=int(lm["intermediate_size"]),
             moe_width=int(lm["moe_intermediate_size"]),
             kinds=list(lm["layer_types"])[:int(lm["num_hidden_layers"])],
             dense_layers=int(lm["num_dense_layers"]), experts=int(lm["num_experts"]),
             top_k=int(lm["num_experts_per_tok"]), conv_size=int(lm["conv_L_cache"]),
             conv_bias=bool(lm["conv_bias"]), eps=float(lm["norm_eps"]),
             theta=float(lm["rope_theta"]), norm_topk_prob=bool(lm["norm_topk_prob"]),
             scaling=float(lm["routed_scaling_factor"]),
             use_expert_bias=bool(lm["use_expert_bias"]), vocab=int(lm["vocab_size"]))
    return d


def spec(d: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every weight: the MME encoder, the matching
    head, the projector and the LM."""
    e, h = d["embed_dim"], d["hidden"]
    out = []

    def linear(name, n_out, n_in, bias=True):
        out.append((name + ".weight", (n_out, n_in), "matrix"))
        if bias:
            out.append((name + ".bias", (n_out,), "bias"))

    def norm(name, width, rms=False):
        out.append((name + ".weight", (width,), "norm_weight"))
        if not rms:
            out.append((name + ".bias", (width,), "norm_bias"))

    linear("video_encoder.unify.0", e, d["feat_dim"])
    for i in range(d["encoder_layers"]):
        p = f"video_encoder.transformer_encoder.layers.{i}"
        out.append((p + ".self_attn.in_proj_weight", (3 * e, e), "matrix"))
        out.append((p + ".self_attn.in_proj_bias", (3 * e,), "bias"))
        linear(p + ".self_attn.out_proj", e, e)
        linear(p + ".linear1", d["encoder_ff"], e)
        linear(p + ".linear2", e, d["encoder_ff"])
        norm(p + ".norm1", e)
        norm(p + ".norm2", e)
    norm("video_encoder.transformer_encoder.norm", e)
    linear("cap_decoder.projector", h, e)
    out.append(("cap_decoder.embed_tokens.weight", (d["vocab"], h), "embedding"))
    kv = d["kv_heads"] * d["head_dim"]
    for i, kind in enumerate(d["kinds"]):
        p = f"cap_decoder.layers.{i}"
        norm(p + ".operator_norm", h, rms=True)
        norm(p + ".ffn_norm", h, rms=True)
        if kind == "conv":
            linear(p + ".conv.in_proj", 3 * h, h, d["conv_bias"])
            out.append((p + ".conv.conv.weight", (h, 1, d["conv_size"]), "conv"))
            if d["conv_bias"]:
                out.append((p + ".conv.conv.bias", (h,), "bias"))
            linear(p + ".conv.out_proj", h, h, d["conv_bias"])
        else:
            linear(p + ".self_attn.q_proj", h, h, False)
            linear(p + ".self_attn.k_proj", kv, h, False)
            linear(p + ".self_attn.v_proj", kv, h, False)
            linear(p + ".self_attn.out_proj", h, h, False)
            norm(p + ".self_attn.q_layernorm", d["head_dim"], rms=True)
            norm(p + ".self_attn.k_layernorm", d["head_dim"], rms=True)
        ff = p + ".feed_forward"
        if i < d["dense_layers"]:
            linear(ff + ".w1", d["dense_width"], h, False)
            linear(ff + ".w3", d["dense_width"], h, False)
            linear(ff + ".w2", h, d["dense_width"], False)
        else:
            n_e, inter = d["experts"], d["moe_width"]
            linear(ff + ".gate", n_e, h, False)
            out.append((ff + ".expert_bias", (n_e,), "expert_bias"))
            out.append((ff + ".experts.w13", (n_e, 2 * inter, h), "matrix"))
            out.append((ff + ".experts.w2", (n_e, h, inter), "matrix"))
    norm("cap_decoder.embedding_norm", h, rms=True)
    linear("matching.v_proj", d["text_dim"], e)
    return out


def _std(kind: str, shape) -> Tuple[float, float]:
    """(mean, std): Xavier-scaled matrices (an expert's alone), token
    embeddings of norm about 1 (the head is tied to them), filters scaled
    by their taps, small non-zero biases, norms about 1, and an expert bias
    that moves a tie-close choice."""
    if kind == "matrix":
        return 0.0, math.sqrt(2.0 / (shape[-2] + shape[-1]))
    if kind == "embedding":
        return 0.0, 1.0 / math.sqrt(shape[1])
    if kind == "conv":
        return 0.0, 1.0 / math.sqrt(shape[-1])
    if kind == "bias":
        return 0.0, 0.02
    if kind == "norm_weight":
        return 1.0, 0.1
    if kind == "expert_bias":
        return 0.0, EXPERT_BIAS_STD
    return 0.0, 0.1  # norm_bias


@torch.no_grad()
def make_weights(d: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor on ``device``}, drawn in ``spec`` order from one
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for key, shape, kind in spec(d):
        mean, std = _std(kind, shape)
        out[key] = torch.randn(shape, generator=gen, device=device).mul_(std).add_(mean)
    return out


def parameters(d: dict) -> int:
    return sum(math.prod(s) for k, s, kind in spec(d) if kind != "expert_bias")


# -- counts ----------------------------------------------------------------------


def positions(d: dict, batch: int) -> Tuple[int, int]:
    """(positions the LM runs a step: the prefix of 1 + max_frames slots and
    the caption's inputs, for each row; the sequence length)."""
    n = 1 + d["max_frames"] + d["max_caption_len"] - 1
    return batch * n, n


def lm_forward_flops(d: dict, batch: int) -> float:
    """Forward operations of the projector, the LM's layers (experts as
    routed) and the tied head over a step's batch."""
    p, n = positions(d, batch)
    h, kv = d["hidden"], d["kv_heads"] * d["head_dim"]
    total = 2.0 * batch * (1 + d["max_frames"]) * d["embed_dim"] * h
    for i, kind in enumerate(d["kinds"]):
        if kind == "conv":
            total += 2.0 * p * h * 4 * h + 2.0 * p * h * d["conv_size"]
        else:
            total += 2.0 * p * h * (2 * h + 2 * kv) + 4.0 * batch * n * n * h
        if i < d["dense_layers"]:
            total += 2.0 * p * h * 3 * d["dense_width"]
        else:
            total += 2.0 * p * h * d["experts"] + d["top_k"] * 2.0 * p * h * 3 * d["moe_width"]
    return total + 2.0 * batch * (d["max_caption_len"] - 1) * h * d["vocab"]


def train_step_flops(d: dict, batch: int) -> float:
    """Model operations of one train step: forward and backward (twice the
    forward) of the encoder and the LM."""
    return 3.0 * (counts.encoder_flops(d, batch, d["max_frames"]) + lm_forward_flops(d, batch))


def expert_launches(d: dict, batch: int) -> Dict[int, List[Dict[str, float]]]:
    """Per mode of the grouped expert kernel, the operations and bytes of its
    launches in one MoE layer's step, in launch order: mode 0 the forward's
    up and down products, mode 1 the backward's two dX products, mode 2 its
    two dW products. Bytes: the bfloat16 weights and rows read once, the
    outputs written once (dW in float32)."""
    p, _ = positions(d, batch)
    r, h, i, n_e = p * d["top_k"], d["hidden"], d["moe_width"], d["experts"]

    def launch(n_out, k, w_bytes, in_rows, out_bytes):
        return {"flops": 2.0 * r * n_out * k, "bytes": w_bytes + in_rows + out_bytes}

    up = launch(2 * i, h, n_e * 2 * i * h * BF16, r * h * BF16, r * 2 * i * BF16)
    down = launch(h, i, n_e * h * i * BF16, r * i * BF16, r * h * BF16)
    d_act = launch(i, h, n_e * h * i * BF16, r * h * BF16, r * i * BF16)
    d_x = launch(h, 2 * i, n_e * 2 * i * h * BF16, r * 2 * i * BF16, r * h * BF16)
    dw2 = launch(h, i, 0, r * (h + i) * BF16, n_e * h * i * F32)
    dw13 = launch(2 * i, h, 0, r * (2 * i + h) * BF16, n_e * 2 * i * h * F32)
    return {0: [up, down], 1: [d_act, d_x], 2: [dw2, dw13]}


def loss_dims(d: dict) -> Dict[str, int]:
    """The sizes ``counts.loss_ops`` reads, at the LM's width and vocab."""
    return {"embed_dim": d["hidden"], "vocab": d["vocab"]}
