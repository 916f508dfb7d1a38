"""Operations and bytes of the program's logical operations, from shapes.

The yardstick of every roofline and ``mfu`` metric: a call's least time on
the card is the larger of its operations over the peak rate and its bytes
over the memory bandwidth. Each input byte is counted read once and each
output byte written once, whatever a kernel reads again; where the work
depends on the data (a decode that stops early, a cache row not yet written)
the count is of what these inputs need. Peaks are NVIDIA's data sheet for
one H100 SXM at 700 W, dense.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def bound_s(n_bytes: float, n_flops: float, dtype: str = "bfloat16") -> float:
    """Least seconds the card could take for this much traffic and work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_FLOPS[dtype])


# -- decoder stack and head -------------------------------------------------

def decoder_layer_weights(d: Dict[str, int]) -> int:
    """Matrix entries of one decoder layer a decode step reads: packed
    self-attention in-projection, out-projection, the cross query and
    out-projection, the two feed-forward matrices."""
    e, f = d["embed_dim"], d["decoder_ff"]
    return 3 * e * e + e * e + e * e + e * e + 2 * e * f


def decoder_layer_vectors(d: Dict[str, int]) -> int:
    """Bias and LayerNorm entries of one decoder layer (all read once)."""
    e, f = d["embed_dim"], d["decoder_ff"]
    return 3 * e + e + e + e + f + e + 6 * e


def stack_step(d: Dict[str, int], rows: int, position: int, t_mem: int) -> Dict[str, float]:
    """One token of the decoder stack for ``rows`` rows at ``position``
    (0-based): every layer's weights once, the ``position + 1`` cache rows
    of K and V it attends (the new row written), the cross K / V of the
    memory, the memory bias, the activations in and out."""
    e, nl = d["embed_dim"], d["decoder_layers"]
    weights = nl * (decoder_layer_weights(d) * BF16 + decoder_layer_vectors(d) * BF16)
    cache = nl * 2 * (position + 1) * rows * e * BF16
    cross = nl * 2 * t_mem * rows * e * BF16
    acts = 2 * rows * e * BF16 + rows * t_mem * F32
    flops = 2.0 * rows * nl * decoder_layer_weights(d)
    flops += 2.0 * 2 * rows * nl * e * (position + 1 + t_mem)  # scores and values
    return {"bytes": weights + cache + cross + acts, "flops": flops}


def head_step(d: Dict[str, int], rows: int, k_out: int = 1) -> Dict[str, float]:
    """The final LayerNorm, the LM head product and its top-``k_out``
    (argmax: 1) for ``rows`` rows: the head's weights and bias, the rows in,
    ``k_out`` values and indices (and a logsumexp) out."""
    e, v = d["embed_dim"], d["vocab"]
    n_bytes = v * e * BF16 + v * F32 + 2 * e * F32 + rows * e * BF16
    n_bytes += rows * (k_out * (F32 + 4) + F32)
    return {"bytes": n_bytes, "flops": 2.0 * rows * v * e}


def whole_step(d: Dict[str, int], rows: int, position: int, t_mem: int) -> Dict[str, float]:
    """One greedy token (stack, norm, head, argmax) as one launch: the two
    parts' traffic, the hidden rows between them never leaving the chip."""
    s, h = stack_step(d, rows, position, t_mem), head_step(d, rows, 1)
    inner = 2 * rows * d["embed_dim"] * BF16  # stack out / head in
    return {"bytes": s["bytes"] + h["bytes"] - inner, "flops": s["flops"] + h["flops"]}


# -- whole programs ------------------------------------------------------------

def encoder_flops(d: Dict[str, int], rows: int, frames: int) -> float:
    """Forward operations of the MME encoder for ``rows`` videos of
    ``frames`` frame slots (the average token in front)."""
    e, f, t = d["embed_dim"], d["encoder_ff"], frames + 1
    out = 2.0 * rows * frames * d["feat_dim"] * e
    per_layer = 2.0 * rows * t * (4 * e * e + 2 * e * f) + 4.0 * rows * t * t * e
    return out + d["encoder_layers"] * per_layer


def decoder_flops(d: Dict[str, int], rows: int, length: int, t_mem: int) -> float:
    """Teacher-forced forward operations of the decoder over ``length``
    positions, the LM head included."""
    e, f, v = d["embed_dim"], d["decoder_ff"], d["vocab"]
    per_layer = (2.0 * rows * length * (3 * e * e + e * e + e * e + e * e + 2 * e * f)
                 + 2.0 * rows * t_mem * 2 * e * e  # cross K / V of the memory
                 + 4.0 * rows * length * length * e + 4.0 * rows * length * t_mem * e)
    return d["decoder_layers"] * per_layer + 2.0 * rows * length * e * v


def train_step_flops(d: Dict[str, int], batch: int, frames: int, caption_len: int) -> float:
    """Model operations of one train step: forward and backward (twice the
    forward) of the encoder and of the decoder over ``caption_len - 1``
    positions; recomputation is not counted."""
    fwd = encoder_flops(d, batch, frames) + decoder_flops(d, batch, caption_len - 1, frames + 1)
    return 3.0 * fwd


def greedy_row_flops(d: Dict[str, int], frames: int, tokens: int) -> float:
    """Useful operations of one served caption: its encoder pass and
    ``tokens`` decode steps (stack and head) with the cache they attend."""
    t_mem = frames + 1
    total = encoder_flops(d, 1, frames) + 2.0 * t_mem * 2 * d["embed_dim"] ** 2 * d["decoder_layers"]
    for pos in range(tokens):
        total += stack_step(d, 1, pos, t_mem)["flops"] + head_step(d, 1)["flops"]
    return total


# -- loss ------------------------------------------------------------------------

def loss_ops(d: Dict[str, int], n_rows: int) -> Dict[str, float]:
    """Operations of the fused SCE loss's three logical operations at
    ``n_rows`` rows: each statistics pass is the [N, E] x [E, V] product;
    the backward recomputes it and takes dx = dz W (dW is a library
    product outside them)."""
    one = 2.0 * n_rows * d["embed_dim"] * d["vocab"]
    return {"softmax_stats": one, "clipped_prob_stats": one, "sce_backward_tiles": 2 * one}
