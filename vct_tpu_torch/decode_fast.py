"""Fused-kernel decoding, greedy and beam (port of the single-device part of
``vct_tpu/decode_fast.py``).

Same tokens as ``vct_tpu_torch.decode.greedy_generate`` up to summation order:
the step runs on ``ops.decode_kernels`` — one ``fused_whole_step`` launch per
token for B <= 64, ``fused_layers_step`` + ``fused_norm_generator_argmax`` above
— with their plain PyTorch versions on CPU tensors. The encoder, the cross
K/V projection and the embedding gather stay plain PyTorch, as they stayed
XLA in the reference.

Two opt-in greedy modes cut the launches per caption: ``multi_step=u`` decodes
``u`` tokens per ``fused_multi_step`` launch, ``sequence_kernel=True`` the
whole caption in one ``fused_sequence_decode`` launch. Beam search
(``beam_generate_fused``) costs one ``fused_layers_step`` and one
``fused_norm_generator_topk`` launch per token over the B*K flattened beams.

The self-cache window ``l_view`` grows in 8-row stages, so early steps read
only the rows they can attend (exact: rows past ``idx`` carry zero weight).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from vct_tpu_torch.ops.decode_kernels import (
    NEG_INF,
    SEQUENCE_MAX_B,
    TOPK_MAX,
    fused_layer_step,
    fused_layers_step,
    fused_multi_step,
    fused_norm_generator_argmax,
    fused_norm_generator_topk,
    fused_sequence_decode,
    fused_whole_step,
    topk_first_win,
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


def layers_step_per_layer(x, ks, vs, cks, cvs, mem_bias, stacked: dict, idx: int, *,
                          heads: int):
    """The decoder stack's step as one ``fused_layer_step`` launch per layer
    -> (x_out, ks, vs): what ``fused_layers_step`` computes over the whole
    cache window, layer by layer, so that a stack that disagrees can be
    narrowed to the layer at fault. No decode entry point takes this route
    (the reference has none for its kernel either); checks drive it."""
    for li in range(ks.shape[0]):
        x, _, _ = fused_layer_step(x, ks[li], vs[li], cks[li], cvs[li], mem_bias,
                                   {k: w[li] for k, w in stacked.items()}, idx, heads=heads)
    return x, ks, vs


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
                x, ks, vs = fused_layers_step(x, ks, vs, cks, cvs, mem_bias, fw["stacked"],
                                              i, heads=heads, l_view=l_view)
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
                          sequence_kernel: Optional[bool] = None,
                          multi_step: Optional[int] = None,
                          fw: Optional[dict] = None):
    """-> (tokens [B, max_len] int32, None). ``fw`` reuses weights already
    extracted by ``extract_fast_weights``. ``single_kernel=None`` takes the
    whole-step kernel for B <= 64. ``multi_step=u`` decodes ``u`` tokens per
    launch (``greedy_generate_multi``); ``sequence_kernel=True`` the whole
    caption in one launch (``ops.decode_kernels.fused_sequence_decode``,
    B <= 32). Both are opt-in: left at None, neither is ever picked."""
    if pad_id is None:
        pad_id = model.config.pad_id  # the same [PAD] the module path zeroes
    b = video_feats[0].shape[0]
    if multi_step:
        if sequence_kernel:
            raise ValueError("multi_step and sequence_kernel are exclusive")
        if single_kernel:
            # refuse rather than drop the request: the multi-step path has
            # its own kernel and no single-kernel variant
            raise ValueError("multi_step and single_kernel are exclusive")
        return greedy_generate_multi(model, video_feats, video_masks, max_len=max_len,
                                     start_id=start_id, end_id=end_id, pad_id=pad_id,
                                     unroll=multi_step, fw=fw)
    if sequence_kernel:
        if b > SEQUENCE_MAX_B:
            raise ValueError(f"sequence kernel is a single batch tile "
                             f"(B <= {SEQUENCE_MAX_B}), got {b}")
        if single_kernel:
            raise ValueError("sequence_kernel runs one fixed launch; single_kernel does "
                             "not apply")
    fw, cks, cvs, mem_bias = _prep_decode(model, video_feats, video_masks, max_len, fw)
    if sequence_kernel:
        tokens = fused_sequence_decode(fw["emb"], fw["pe"], cks, cvs, mem_bias, fw,
                                       heads=fw["heads"], max_len=max_len,
                                       start_id=start_id, end_id=end_id, pad_id=pad_id)
        return tokens, None
    tokens = _decode_loop(fw, cks, cvs, mem_bias, max_len=max_len, start_id=start_id,
                          end_id=end_id, pad_id=pad_id,
                          single_kernel=_resolve_tiling(b, single_kernel))
    return tokens, None


def _prep_decode(model, video_feats, video_masks, max_len: int, fw: Optional[dict],
                 beam_size: int = 1):
    """Encode and lay out the cross K/V -> (fw, cks [NL, Tm, B*K, E], cvs,
    mem_bias [B*K, Tm]). With ``beam_size`` K > 1 the memory is repeated once
    per beam, row-major, so one video's beams are contiguous rows; the cross
    K/V are the same for every beam of a video and never regathered."""
    if fw is None:
        fw = extract_fast_weights(model)
    memory, mem_mask, _ = model.encode(list(video_feats),
                                       list(video_masks) if video_masks else None)
    if beam_size > 1:
        memory = memory.repeat_interleave(beam_size, dim=0)
        if mem_mask is not None:
            mem_mask = mem_mask.repeat_interleave(beam_size, dim=0)
    cks, cvs, mem_bias = _layout_caches(model, memory, mem_mask, max_len=max_len)
    return fw, cks, cvs, mem_bias


# ---------------------------------------------------------------------------
# several tokens per launch
# ---------------------------------------------------------------------------


@torch.no_grad()
def greedy_generate_multi(model, video_feats: Sequence[torch.Tensor],
                          video_masks: Optional[Sequence[torch.Tensor]], *,
                          max_len: int = 30, start_id: int = 101, end_id: int = 102,
                          pad_id: Optional[int] = None, unroll: int = 4,
                          fw: Optional[dict] = None):
    """-> (tokens [B, max_len] int32, None): greedy decode at ``unroll``
    tokens per launch (``ops.decode_kernels.fused_multi_step``). The kernel
    emits raw argmax chains; the all-rows-finished -> pad rule is applied
    here between windows, so the tokens equal ``greedy_generate_fused``'s.
    ``unroll`` must divide the cache length ``round_up(max_len, 8)``. The
    host tests for the early exit once per stage of windows."""
    if pad_id is None:
        pad_id = model.config.pad_id
    u = unroll
    l_pad = _round_up(max_len, 8)
    if u < 1 or l_pad % u:
        raise ValueError(f"unroll {u} must divide the cache length {l_pad}")
    fw, cks, cvs, mem_bias = _prep_decode(model, video_feats, video_masks, max_len, fw)
    nl, _, b, e = cks.shape
    dt, dev = cks.dtype, cks.device
    ks = torch.zeros((nl, l_pad, b, e), dtype=dt, device=dev)
    vs = torch.zeros((nl, l_pad, b, e), dtype=dt, device=dev)
    # + u slack columns take the last window's overshoot past max_len
    tokens = torch.full((b, l_pad + u), pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_id
    cur = torch.full((b,), start_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    all_done = torch.zeros((), dtype=torch.bool, device=dev)

    n_windows = -(-(max_len - 1) // u)
    w = hi_w = 0
    while hi_w < n_windows:
        # stages of growing cache windows, 8-row aligned like the per-token
        # loop; l_view covers every row the stage's windows touch
        hi_w = min(hi_w + max(8 // u, 1), n_windows)
        l_view = min(_round_up(hi_w * u, 8), l_pad)
        while w < hi_w:
            toks_u, ks, vs = fused_multi_step(cur, ks, vs, cks, cvs, mem_bias, fw["emb"],
                                              fw["pe"], fw, w, heads=fw["heads"],
                                              unroll=u, pad_id=pad_id, l_view=l_view)
            for j in range(u):
                tok_j = torch.where(all_done, pad_id, toks_u[:, j])
                tokens[:, w * u + j + 1] = tok_j
                done |= tok_j == end_id
                all_done = done.all()
            cur = tok_j.contiguous()
            w += 1
        if bool(all_done):
            break
    return tokens[:, :max_len].contiguous(), None


# ---------------------------------------------------------------------------
# beam search on the kernels
# ---------------------------------------------------------------------------


def fused_beam_supported(beam_size: int) -> bool:
    """The beam widths the kernel path carries on a card: the step kernel
    takes any number of B*K rows (the reference's batch-tile rule is gone),
    the top-k kernel up to ``TOPK_MAX`` candidates per row."""
    return 1 <= beam_size <= TOPK_MAX


@torch.no_grad()
def _beam_loop(fw: dict, cks, cvs, mem_bias, *, beam_size: int, max_len: int,
               start_id: int, end_id: int, pad_id: int, length_penalty: float):
    """The kernel beam loop over cks [NL, Tm, B*K, E] -> (tokens [B, max_len]
    int32, scores [B]). The [B, K, K] candidate merge and the regather of the
    self-attention cache stay plain PyTorch. The host tests "every beam has
    finished" once per 8-step stage (exact: see ``decode.beam_generate``)."""
    from vct_tpu_torch.decode import beam_advance, beam_select, beam_start

    k = beam_size
    nl, _, bk, e = cks.shape
    b = bk // k
    dt, dev = cks.dtype, cks.device
    heads = fw["heads"]
    l_pad = _round_up(max_len, 8)
    ks = torch.zeros((nl, l_pad, bk, e), dtype=dt, device=dev)
    vs = torch.zeros((nl, l_pad, bk, e), dtype=dt, device=dev)
    # the regather reads rows the step kernel writes in place: it gathers
    # into these second buffers, never into its own source
    ks2, vs2 = torch.zeros_like(ks), torch.zeros_like(vs)
    tokens, scores, finished, lengths = beam_start(b, k, max_len, start_id, pad_id, dev)
    emb, pe = fw["emb"], fw["pe"]
    # a frozen (finished) beam: candidate slot 0 is [PAD] at zero cost, the
    # rest can never win
    frozen_logp = torch.full((k,), NEG_INF, dtype=torch.float32, device=dev)
    frozen_logp[0] = 0.0
    batch_base = torch.arange(b, device=dev)[:, None] * k

    i = hi = 0
    while hi < max_len - 1:
        hi = min(hi + 8, max_len - 1)
        l_view = min(_round_up(hi, 8), l_pad)
        while i < hi:
            cur = tokens.reshape(bk, max_len)[:, i]
            x = emb[cur.long()].masked_fill((cur == pad_id)[:, None], 0.0)
            x = (x + pe[i]).contiguous()
            x, ks, vs = fused_layers_step(x, ks, vs, cks, cvs, mem_bias, fw["stacked"], i,
                                          heads=heads, l_view=l_view)
            topv, topi, lse = fused_norm_generator_topk(x, fw["norm_s"], fw["norm_b"],
                                                        fw["wg"], fw["bg"], k=k)
            logp_top = (topv - lse[:, None]).reshape(b, k, k)
            logp_eff = torch.where(finished[..., None], frozen_logp, logp_top)
            tok_eff = torch.where(finished[..., None], pad_id, topi.reshape(b, k, k))
            cand = scores[..., None] + logp_eff  # [B, K, K]
            scores, idx = topk_first_win(cand.reshape(b, k * k), k)
            beam_idx = idx // k
            tok_idx = torch.gather(tok_eff.reshape(b, k * k), 1, idx)
            tokens, finished, lengths = beam_advance(tokens, finished, lengths, beam_idx,
                                                     tok_idx, i, end_id)
            # only the first l_view rows: within a stage every later row is
            # still zero for every beam, and a permutation of zeros is itself
            flat = (batch_base + beam_idx).reshape(-1)
            for li in range(nl):  # per layer: a contiguous [l_view, B*K, E] target
                torch.index_select(ks[li, :l_view], 1, flat, out=ks2[li, :l_view])
                torch.index_select(vs[li, :l_view], 1, flat, out=vs2[li, :l_view])
            ks, ks2, vs, vs2 = ks2, ks, vs2, vs
            i += 1
        if bool(finished.all()):
            break
    return beam_select(tokens, scores, lengths, length_penalty)


@torch.no_grad()
def beam_generate_fused(model, video_feats: Sequence[torch.Tensor],
                        video_masks: Optional[Sequence[torch.Tensor]], *,
                        beam_size: int = 4, max_len: int = 30, start_id: int = 101,
                        end_id: int = 102, pad_id: Optional[int] = None,
                        length_penalty: float = 0.6, fw: Optional[dict] = None):
    """Fixed-width beam search on the decode kernels -> (tokens [B, max_len]
    int32, scores [B]).

    Same selection as ``decode.beam_generate`` (frozen finished beams, GNMT
    length penalty, lowest-index tie-breaks), but the [B*K, vocab] log-softmax
    is never stored: the top-k over K*V candidates is recovered from each
    beam's k best logits and its logsumexp, since a beam's score is a
    constant over its row. The kernel's logsumexp rounds differently from a
    one-pass log-softmax, so candidates of different beams within a rounding
    of each other may rank the other way on the two paths. On a card a beam
    wider than the top-k kernel carries raises; nothing gives way to the
    plain versions there."""
    if pad_id is None:
        pad_id = model.config.pad_id
    if video_feats[0].is_cuda and not fused_beam_supported(beam_size):
        raise ValueError(f"beam_size={beam_size} outside 1..{TOPK_MAX}, the beam widths the "
                         f"top-k kernel carries")
    fw, cks, cvs, mem_bias = _prep_decode(model, video_feats, video_masks, max_len, fw,
                                          beam_size)
    return _beam_loop(fw, cks, cvs, mem_bias, beam_size=beam_size, max_len=max_len,
                      start_id=start_id, end_id=end_id, pad_id=pad_id,
                      length_penalty=length_penalty)


def make_fused_beam_fn(model, max_len: int, start_id: int, end_id: int, beam_size: int,
                       length_penalty: float = 0.6, *, fw: Optional[dict] = None
                       ) -> Callable:
    """fn(feats, masks) -> (tokens, scores) on the kernel beam path."""

    def fn(video_feats, video_masks):
        return beam_generate_fused(model, video_feats, video_masks, beam_size=beam_size,
                                   max_len=max_len, start_id=start_id, end_id=end_id,
                                   length_penalty=length_penalty, fw=fw)

    return fn
