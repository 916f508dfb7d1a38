"""Fused-kernel greedy decoding (port of the greedy part of
``vct_tpu/decode_fast.py``).

Same tokens as ``vct_tpu_torch.decode.greedy_generate`` up to summation order:
the step runs on ``ops.decode_kernels`` — one ``fused_whole_step`` launch per
token for B <= 64, ``fused_layers_step`` + ``fused_norm_generator_argmax`` above
— with their plain PyTorch versions on CPU tensors. The encoder, the cross
K/V projection and the embedding gather stay plain PyTorch, as they stayed
XLA in the reference.

The self-cache window ``l_view`` grows in 8-row stages, so early steps read
only the rows they can attend (exact: rows past ``idx`` carry zero weight).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vct_tpu_torch.ops.decode_kernels import (
    NEG_INF,
    fused_layers_step,
    fused_norm_generator_argmax,
    fused_whole_step,
)


VOCAB_PAD = 1024  # the reference's vocab tile; any multiple of 8 works here


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@torch.no_grad()
def extract_fast_weights(model) -> dict:
    """The decoder's weights as the kernels take them: matrices [in, out] in
    the compute dtype stacked over layers, LayerNorms float32, the vocab
    projection padded to a multiple of ``VOCAB_PAD`` with ``NEG_INF`` bias on
    the pad columns (they never win the argmax)."""
    cdec = model.cap_decoder
    dec = cdec.decoder
    e = model.config.embed_dim
    dt = model.dtype

    def mat(w):  # torch [out, in] -> [in, out]
        return w.detach().t().to(dt)

    def vec(b, dtype=None):
        return b.detach().to(dtype or dt)

    layers = []
    for layer in dec.layers:
        sa, ca = layer.self_attn, layer.multihead_attn
        f32 = torch.float32
        layers.append({
            "wqkv": mat(sa.in_proj_weight), "bqkv": vec(sa.in_proj_bias),
            "wo": mat(sa.out_proj.weight), "bo": vec(sa.out_proj.bias),
            "wcq": mat(ca.in_proj_weight[:e]), "bcq": vec(ca.in_proj_bias[:e]),
            "wco": mat(ca.out_proj.weight), "bco": vec(ca.out_proj.bias),
            "n1s": vec(layer.norm1.weight, f32), "n1b": vec(layer.norm1.bias, f32),
            "n2s": vec(layer.norm2.weight, f32), "n2b": vec(layer.norm2.bias, f32),
            "w1": mat(layer.linear1.weight), "b1": vec(layer.linear1.bias),
            "w2": mat(layer.linear2.weight), "b2": vec(layer.linear2.bias),
            "n3s": vec(layer.norm3.weight, f32), "n3b": vec(layer.norm3.bias, f32),
        })
    stacked = {k: torch.stack([lw[k] for lw in layers]).contiguous() for k in layers[0]}

    wg = mat(cdec.generator.weight)
    bg = cdec.generator.bias.detach().float()
    v = wg.shape[1]
    v_pad = _round_up(v, VOCAB_PAD)
    if v_pad != v:
        wg = torch.nn.functional.pad(wg, (0, v_pad - v))
        bg = torch.nn.functional.pad(bg, (0, v_pad - v), value=NEG_INF)
    return {
        "stacked": stacked,
        "norm_s": dec.norm.weight.detach().float().contiguous(),
        "norm_b": dec.norm.bias.detach().float().contiguous(),
        "wg": wg.contiguous(),
        "bg": bg.contiguous(),
        "emb": cdec.tgt_to_emb.weight.detach().to(dt),
        "pe": cdec.positional_encoding.pos_embedding.detach().to(dt),
        "heads": model.config.caption_decoder.nhead,
    }


def _resolve_tiling(b: int, single_kernel: Optional[bool]) -> bool:
    """B <= 64 runs the whole-step kernel unless told otherwise (the
    reference's multiple-of-8 batch rule was a TPU tiling rule and is gone)."""
    return b <= 64 if single_kernel is None else single_kernel


@torch.no_grad()
def _layout_caches(model, memory, mem_mask, *, max_len: int):
    """Cross K/V in the kernels' layout -> (cks [NL, Tm, B, E], cvs,
    mem_bias [B, Tm] float32)."""
    e = model.config.embed_dim
    b, tm = memory.shape[:2]
    caches = model.init_cache(b, max_len, memory)
    cks = torch.stack([c["ck"].reshape(b, tm, e).transpose(0, 1) for c in caches])
    cvs = torch.stack([c["cv"].reshape(b, tm, e).transpose(0, 1) for c in caches])
    zero = torch.zeros((), dtype=torch.float32, device=memory.device)
    if mem_mask is not None and not model.tpu.quirk_no_memory_mask_in_decoder:
        mem_bias = torch.where(mem_mask, NEG_INF, zero)
    else:
        mem_bias = torch.zeros((b, tm), dtype=torch.float32, device=memory.device)
    return (cks.to(model.dtype).contiguous(), cvs.to(model.dtype).contiguous(),
            mem_bias.contiguous())


@torch.no_grad()
def _decode_loop(fw: dict, cks, cvs, mem_bias, *, max_len: int, start_id: int,
                 end_id: int, pad_id: int, single_kernel: bool) -> torch.Tensor:
    """The kernel greedy loop -> tokens [B, max_len] int32. Rows that finished
    keep receiving argmax tokens until every row has; from then on every
    token is ``pad_id`` (the reference's early exit). The host checks for
    that once per 8-step stage."""
    nl, _, b, e = cks.shape
    dt, dev = cks.dtype, cks.device
    heads = fw["heads"]
    l_pad = _round_up(max_len, 8)
    ks = torch.zeros((nl, l_pad, b, e), dtype=dt, device=dev)
    vs = torch.zeros((nl, l_pad, b, e), dtype=dt, device=dev)
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_id
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    all_done = torch.zeros((), dtype=torch.bool, device=dev)
    emb, pe = fw["emb"], fw["pe"]

    i = hi = 0
    while hi < max_len - 1:
        hi = min(hi + 8, max_len - 1)
        l_view = min(_round_up(hi, 8), l_pad)
        while i < hi:
            cur = tokens[:, i]
            x = emb[cur.long()].masked_fill((cur == pad_id)[:, None], 0.0)
            x = (x + pe[i]).contiguous()
            if single_kernel:
                nxt, ks, vs = fused_whole_step(x, ks, vs, cks, cvs, mem_bias, fw, i,
                                               heads=heads, l_view=l_view)
            else:
                x, ks, vs = fused_layers_step(x, ks, vs, cks, cvs, mem_bias,
                                              fw["stacked"], i, heads=heads,
                                              l_view=l_view)
                nxt = fused_norm_generator_argmax(x, fw["norm_s"], fw["norm_b"],
                                                  fw["wg"], fw["bg"])
            nxt = torch.where(all_done, pad_id, nxt)
            tokens[:, i + 1] = nxt
            done |= nxt == end_id
            all_done = done.all()
            i += 1
        if bool(all_done):
            break
    return tokens


@torch.no_grad()
def greedy_generate_fused(model, video_feats: Sequence[torch.Tensor],
                          video_masks: Optional[Sequence[torch.Tensor]], *,
                          max_len: int = 30, start_id: int = 101, end_id: int = 102,
                          pad_id: Optional[int] = None,
                          single_kernel: Optional[bool] = None,
                          fw: Optional[dict] = None):
    """-> (tokens [B, max_len] int32, None). ``fw`` reuses weights already
    extracted by ``extract_fast_weights``."""
    if pad_id is None:
        pad_id = model.config.pad_id  # the same [PAD] the module path zeroes
    b = video_feats[0].shape[0]
    single_kernel = _resolve_tiling(b, single_kernel)
    if fw is None:
        fw = extract_fast_weights(model)
    memory, mem_mask, _ = model.encode(list(video_feats),
                                       list(video_masks) if video_masks else None)
    cks, cvs, mem_bias = _layout_caches(model, memory, mem_mask, max_len=max_len)
    tokens = _decode_loop(fw, cks, cvs, mem_bias, max_len=max_len, start_id=start_id,
                          end_id=end_id, pad_id=pad_id, single_kernel=single_kernel)
    return tokens, None
