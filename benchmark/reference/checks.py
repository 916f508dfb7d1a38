"""The comparisons that decide ``correct``, against the plain reference.

Each takes what the program produced (served tokens; a beam search's
captions and scores; a training run's losses and per-leaf norms) together
with the inputs the benchmark made, works the reference out again from those
inputs (weights from the seed, features fitted to the frame slots, captions
tokenized), and returns one number. ``precision="fp8"`` reads the control
instead: the reference itself in the next precision below the
configuration's bf16, in the program's place.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchlib import data
from benchlib.weights import float32, make_weights
from reference import model as ref

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
TINY_GRAD = 1e-3  # a leaf whose gradient is under this share of the median leaf's


def logical_leaves(name: str, t: torch.Tensor):
    """The model's parameters as logical leaves: a packed attention
    in-projection is three (its query, key and value parts), so that a
    key's bias, which softmax gives no gradient, is a leaf of its own."""
    if name.endswith((".in_proj_weight", ".in_proj_bias")):
        return [(f"{name}[{part}]", chunk) for part, chunk in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def leaf_norms(tensors) -> Dict[str, float]:
    """{logical leaf: norm} of (name, tensor) pairs."""
    return {k: float(v.norm()) for name, t in tensors for k, v in logical_leaves(name, t)}


def sample_rows(seed: int, lengths: Sequence[int], n: int) -> List[int]:
    """Indices of ``n`` rows drawn from the seed, the longest among them."""
    if not lengths:
        return []
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 4242])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in pick)


def greedy_length(tokens: np.ndarray) -> int:
    """Positions of a greedy caption that are its own: through its first
    end token, or every position without one."""
    t = [int(x) for x in tokens]
    return t.index(data.END_ID, 1) if data.END_ID in t[1:] else len(t) - 1


def fitted(feats: Sequence[np.ndarray], max_frames: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    pairs = [ref.fit_frames(f, max_frames) for f in feats]
    x = torch.as_tensor(np.stack([p[0] for p in pairs]), device=device)
    pad = torch.as_tensor(np.stack([p[1] for p in pairs]), device=device)
    return x, pad


def _blocks(n: int, size: int):
    for lo in range(0, n, size):
        yield lo, min(n, lo + size)


@torch.no_grad()
def greedy_gap(dims: Dict[str, int], seed: int, feats: List[np.ndarray],
               tokens: List[np.ndarray], device, precision: str = "float32",
               block: int = 64) -> float:
    """Served greedy tokens: the widest gap, over the sampled captions and
    their own positions, between the float32 reference's best logit and its
    logit of the token served there (of the token the fp8 reference puts
    first there, for the control). Teacher-forced on the served tokens."""
    if not tokens:
        return 0.0
    ref.no_tf32()
    W = float32(make_weights(dims, seed, device))
    p32, low = ref.Precision("float32"), ref.Precision(precision)
    worst = 0.0
    for lo, hi in _blocks(len(tokens), block):
        x, pad = fitted(feats[lo:hi], dims["max_frames"], device)
        tok = torch.as_tensor(np.stack(tokens[lo:hi]).astype(np.int64), device=device)
        memory, mem_pad = ref.encode(W, dims, x, pad, p32)
        logits = ref.logits_of(W, ref.decode_hidden(W, dims, memory, mem_pad, tok[:, :-1], p32),
                               p32)
        if precision == "float32":
            chosen = tok[:, 1:]
        else:
            m8, pad8 = ref.encode(W, dims, x, pad, low)
            chosen = ref.logits_of(W, ref.decode_hidden(W, dims, m8, pad8, tok[:, :-1], low),
                                   low).argmax(dim=-1)
        gap = logits.max(dim=-1).values - logits.gather(2, chosen[..., None])[..., 0]
        for r in range(hi - lo):
            upto = greedy_length(tokens[lo + r])
            worst = max(worst, float(gap[r, :upto].max()))
    return worst


@torch.no_grad()
def beam_gaps(dims: Dict[str, int], seed: int, feats: List[np.ndarray],
              tokens: List[np.ndarray], scores: List[float], device, *, beam: int,
              length_penalty: float, precision: str = "float32",
              block: int = 32) -> Dict[str, float]:
    """A beam search's captions and their reported scores, teacher-forced
    through the float32 reference -> ``beam_score_gap``, the widest gap
    between a caption's reported score and the reference's score of the same
    caption (its tokens' log-probabilities through its end, over the length
    penalty); and ``beam_rank_gap``, the widest amount, over the captions'
    own positions, by which a kept token's log-probability lies below the
    ``beam``-th best of its prefix. A search that keeps the best ``beam``
    continuations of its hypotheses keeps only tokens among the ``beam``
    best of their own prefix, so a top-k that keeps the wrong candidates
    shows here even where it scores them right. The control ("fp8") runs
    the reference's own beam search in fp8 and is held to the same numbers."""
    if not tokens:
        return {"beam_score_gap": 0.0, "beam_rank_gap": 0.0}
    ref.no_tf32()
    W = float32(make_weights(dims, seed, device))
    p32, low = ref.Precision("float32"), ref.Precision(precision)
    score_gap = rank_gap = 0.0
    for lo, hi in _blocks(len(tokens), block):
        x, pad = fitted(feats[lo:hi], dims["max_frames"], device)
        memory, mem_pad = ref.encode(W, dims, x, pad, p32)
        if precision == "float32":
            got = torch.as_tensor(np.stack(tokens[lo:hi]).astype(np.int64), device=device)
            claimed = torch.as_tensor(scores[lo:hi], device=device, dtype=torch.float32)
        else:
            m8, pad8 = ref.encode(W, dims, x, pad, low)
            got, claimed = ref.beam_search(W, dims, m8, pad8, beam=beam,
                                           max_len=dims["max_length"], start_id=data.START_ID,
                                           end_id=data.END_ID, length_penalty=length_penalty,
                                           prec=low)
        truth, below = ref.hypothesis_scores(W, dims, memory, mem_pad, got, end_id=data.END_ID,
                                             length_penalty=length_penalty, prec=p32,
                                             rank=beam)
        score_gap = max(score_gap, float((claimed - truth).abs().max()))
        rank_gap = max(rank_gap, float(below.max()))
    return {"beam_score_gap": score_gap, "beam_rank_gap": rank_gap}


def train_batch(dims: Dict[str, int], seed: int, split: int, rows: Sequence[Tuple[int, str]],
                frames: Sequence[int], device):
    """The reference's own copy of one consumed batch: each (video index,
    caption) row's features from the seed, fitted to the frame slots, and
    the caption's ids."""
    feats = [data.video_features(seed, split, i, frames, dims["feat_dim"]) for i, _ in rows]
    x, pad = fitted(feats, dims["max_frames"], device)
    ids = np.zeros((len(rows), dims["max_caption_len"]), dtype=np.int64)
    for r, (_, cap) in enumerate(rows):
        c = data.caption_ids(cap, dims["max_caption_len"])
        ids[r, :len(c)] = c
    return x, pad, torch.as_tensor(ids, device=device)


def logical_grads(tensors) -> Dict[str, torch.Tensor]:
    """{logical leaf: tensor} of (name, tensor) pairs."""
    return {k: v for name, t in tensors for k, v in logical_leaves(name, t)}


def train_reference(dims: Dict[str, int], seed: int, batches, device, *, lr: float,
                    dropout: float, dropout_seed: int, precision: str = "float32",
                    rows: slice = slice(None)):
    """Three (or ``len(batches)``) Adam steps of the reference from the
    seed's float32 master weights, with dropout masks drawn from a generator seeded as the
    program's -> (losses, the first gradient by logical leaf, parameter
    change norm per leaf after the last step). ``rows`` keeps part of each
    batch (a fault: half of it left out)."""
    ref.no_tf32()
    W0 = make_weights(dims, seed, device, torch.float32)
    trained = [k for k in W0 if not k.startswith("matching.")]
    W = {k: (v.clone().requires_grad_(True) if k in trained else v) for k, v in W0.items()}
    prec = ref.Precision(precision)
    drop = ref.Dropout(dropout, torch.Generator(device=device).manual_seed(int(dropout_seed)))
    m = {k: torch.zeros_like(W[k]) for k in trained}
    v = {k: torch.zeros_like(W[k]) for k in trained}
    losses, first = [], {}
    b1, b2 = ADAM_BETAS
    for step, (x, pad, ids) in enumerate(batches, start=1):
        loss = ref.caption_loss(W, dims, x[rows], pad[rows], ids[rows], prec, drop)
        grads = torch.autograd.grad(loss, [W[k] for k in trained])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 1:
                first = logical_grads(zip(trained, grads))
            for k, g in zip(trained, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** step)).sqrt() + ADAM_EPS
                W[k] -= lr * (m[k] / (1 - b1 ** step)) / denom
        del grads, loss
    change = leaf_norms((k, W[k].detach() - W0[k]) for k in trained)
    return losses, first, change


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keys: Sequence[str]) -> List[float]:
    """Per leaf, the gap between the program's and the reference's number,
    against the larger of that leaf's reference norm and the median leaf's."""
    med = float(np.median([reference[k] for k in keys]))
    return [abs(program.get(k, 0.0) - reference[k]) / max(reference[k], med) for k in keys]


@torch.no_grad()
def train_gaps(program: Dict[str, object], reference: Tuple) -> Dict[str, float]:
    """The program's readings against the reference's: ``loss_gap``, the
    relative gap of the first step's loss; ``later_loss_gap``, the widest
    relative gap of the later steps' losses; ``grad_gap``, the widest leaf
    gap between the norms of the first gradient; ``grad_error``, the widest
    leaf's norm of the first gradient's difference, against the same scale;
    ``change_gap``, the widest leaf gap between the norms of the parameters'
    change over the steps. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change."""
    r_loss, r_first, r_change = reference
    keys = sorted(r_first)
    r_grad = {k: float(r_first[k].norm()) for k in keys}
    p_first = program["grads"]
    p_grad = {k: float(g.norm()) for k, g in p_first.items()}
    diff = {k: (float((p_first[k].to(r_first[k].device) - r_first[k]).norm()) if k in p_first
                else r_grad[k]) for k in keys}
    med = float(np.median([r_grad[k] for k in keys]))
    moving = [k for k in keys if r_grad[k] >= TINY_GRAD * med]
    p_loss = program["losses"]
    later = [abs(p - r) / abs(r) for p, r in zip(p_loss[1:], r_loss[1:])]
    return {"loss_gap": abs(p_loss[0] - r_loss[0]) / abs(r_loss[0]),
            "later_loss_gap": max(later, default=0.0),
            "grad_gap": max(leaf_gaps(p_grad, r_grad, keys)),
            "grad_error": max(d / max(r_grad[k], med) for k, d in diff.items()),
            "change_gap": max(leaf_gaps(program["change_norms"], r_change, moving))}
