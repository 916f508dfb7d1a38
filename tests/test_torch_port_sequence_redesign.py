"""What the bfloat16 ``fused_sequence_decode`` and ``fused_layer_step`` on the
small-row token path of ``csrc/small_step.cu`` rest on that a CPU can check:

* the launch plan ``sequence_decode_plan``, which mirrors the C launcher
  (the card tests hold it to what ``vct_sequence_decode_plan`` reports): the
  rule of ``multi_step_plan`` at 1-32 rows, its boundaries at B = 1, 32 and
  33, float32, widths that are not multiples of 64, route 0, and the
  refusals;
* ``fused_layer_step``'s launch: ``fused_layers_step``'s at NL = 1 with route
  -1, so ``stack_step_plan``'s rule picks the kernel (the small-row kernel at
  1-64 rows, ``stack_step_kernel`` at 65-2048, ``decode_step_kernel``
  otherwise), and an ``idx`` outside the cache refused by both versions and
  every route alike;
* the float32 model of the small-row kernel's work split
  (``test_torch_port_step_redesign.py``) run as the sequence kernel runs it
  (the start token, the done flags, the loop left once every row is done,
  caches that are read only where written) against
  ``fused_sequence_decode_reference`` at B = 1, 7 and 32, with ``end_id``
  never met, met by some rows, and met by every row at step 1; and at NL = 1
  against ``fused_layer_step_reference``.

The plain versions' parity with ``vct_tpu``'s Pallas kernels in interpret
mode is held by ``test_torch_port_multistep.py`` (the sequence kernel) and
``test_torch_port_beam.py`` (the layer step). Tolerances are those of
``test_torch_port_step_redesign.py``: the model sums in another order than
the plain versions, so activations agree to 1e-5 of their largest value, and
tokens wherever the plain logits' top-2 gap is above 1e-4.
"""

import pytest
import torch

from tests.test_torch_port_step_redesign import GAP, MSVD, _model_data, _plain_gaps, \
    _token_model
from vct_tpu_torch.ops import decode_kernels as dk

BF16, F32 = torch.bfloat16, torch.float32

# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,e,heads,f,v,dtype,route,want", [
    # the rule: bfloat16 at 1-32 rows within every limit takes the small-row kernel
    (1, *MSVD, BF16, -1, (1, 0)), (32, *MSVD, BF16, -1, (1, 0)),
    (7, 128, 4, 256, 640, BF16, -1, (1, 0)), (32, 1024, 8, 2304, 1024, BF16, -1, (1, 0)),
    # and says why it does not
    (1, *MSVD, F32, -1, (0, 2)), (32, *MSVD, F32, -1, (0, 2)), (32, *MSVD, BF16, 0, (0, 1)),
    (32, 96, 12, 256, 1024, BF16, -1, (0, 4)), (7, 768, 8, 2000, 1024, BF16, -1, (0, 4)),
    (32, 1280, 8, 2048, 1024, BF16, -1, (0, 5)), (32, 768, 2, 2048, 1024, BF16, -1, (0, 6)),
    (32, 768, 8, 2560, 1024, BF16, -1, (0, 7)),
    # asked for
    (32, *MSVD, BF16, 1, (1, 0)), (1, 128, 4, 256, 640, F32, 0, (0, 1)),
])
def test_sequence_plan_rule_and_boundaries(b, e, heads, f, v, dtype, route, want):
    plan = dk.sequence_decode_plan(b, e, heads, f, v, dtype, route)
    assert (plan.route, plan.why) == want
    assert plan.why in dk.SMALL_WHY
    assert plan == dk.multi_step_plan(b, e, heads, f, v, dtype, route)   # the same token loop
    if plan.route == 1:
        assert (plan.rows, plan.cols, plan.kstep, plan.stages) == (16, 8, 256, 4)
        assert plan.smem_bytes == 212992 <= 232448
    else:   # decode_multi_kernel: decode_step_kernel's, then the ids and done flags
        step = 4 * (8 * max(e, f) + 8 * 8 * 32 + 8 * 1024)
        assert plan.smem_bytes == step + 4 * ((2 * b + 3) // 4 * 4)


@pytest.mark.parametrize("b,e,heads,f,v,dtype,route", [
    # past the reference's batch rule neither route runs, though the
    # small-row kernel takes 64 rows elsewhere
    (33, *MSVD, BF16, -1), (33, *MSVD, BF16, 0), (33, *MSVD, BF16, 1), (64, *MSVD, F32, -1),
    (1, *MSVD, F32, 1), (32, 768, 8, 2560, 1024, BF16, 1), (0, *MSVD, BF16, -1),
    (32, 768, 7, 2048, 1024, BF16, -1), (32, 768, 8, 2048, 1020, BF16, -1),
    (32, *MSVD, BF16, 2), (32, *MSVD, torch.float16, -1),
])
def test_sequence_plan_refuses(b, e, heads, f, v, dtype, route):
    with pytest.raises((ValueError, TypeError)):
        dk.sequence_decode_plan(b, e, heads, f, v, dtype, route)


def test_sequence_wrapper_keeps_the_reference_batch_rule():
    fw, (_, _, _, ck, cv, mb) = _model_data(dk.SEQUENCE_MAX_B + 1, seed=3)
    with pytest.raises(ValueError, match="B <= 32"):
        dk.fused_sequence_decode(fw["emb"], fw["pe"], ck, cv, mb, fw, heads=4, max_len=6,
                                 start_id=1, end_id=-1)


@pytest.mark.parametrize("b,dtype,want", [
    (1, BF16, (2, 0)), (32, BF16, (2, 0)), (64, BF16, (2, 0)), (65, BF16, (1, 0)),
    (256, BF16, (1, 0)), (2048, BF16, (1, 0)), (2049, BF16, (0, 3)), (32, F32, (0, 2)),
    (256, F32, (0, 2)),
])
def test_layer_step_passes_the_stack_rule_at_one_layer(monkeypatch, b, dtype, want):
    """On the card the wrapper launches the stack at NL = 1 with route -1 on
    views of the layer's tensors (no copy); ``stack_step_plan``'s rule then
    picks the kernel. The launch is recorded here instead of made."""
    e, heads, f, big_l, tm = 128, 4, 256, 16, 7
    seen = []

    def record(x, kc, vc, ck, cv, mb, stacked, idx, hd, l_view, gen, route=-1):
        seen.append((kc, vc, ck, cv, stacked, idx, l_view, gen, route))
        return torch.empty_like(x)

    monkeypatch.setattr(dk, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(dk, "_launch_step", record)
    cache = torch.zeros((3, big_l, b, e), dtype=dtype)
    shapes = {"wqkv": (e, 3 * e), "bqkv": (3 * e,), "w1": (e, f), "b1": (f,), "w2": (f, e)}
    w = {k: torch.zeros((3, *shapes.get(k, (e, e) if k[0] == "w" else (e,))),
                        dtype=F32 if k in dk._NORM_KEYS else dtype) for k in dk.STACK_KEYS}
    layer = {k: v[1] for k, v in w.items()}
    cross = torch.zeros((3, tm, b, e), dtype=dtype)
    before = dk.fused_layer_step.launches
    dk.fused_layer_step(torch.zeros((b, e), dtype=dtype), cache[1], cache[2], cross[1],
                        cross[2], None, layer, 5, heads=heads)
    assert dk.fused_layer_step.launches == before + 1
    (kc, vc, ck, cv, stacked, idx, l_view, gen, route), = seen
    assert (idx, l_view, gen, route) == (5, None, None, -1)
    assert kc.shape == (1, big_l, b, e) and ck.shape == (1, tm, b, e)
    assert kc.data_ptr() == cache[1].data_ptr() and cv.data_ptr() == cross[2].data_ptr()
    assert all(stacked[k].shape[0] == 1 and stacked[k].data_ptr() == layer[k].data_ptr()
               for k in dk.STACK_KEYS)
    plan = dk.stack_step_plan(b, e, heads, f, dtype)
    assert (plan.route, plan.why) == want


@pytest.mark.parametrize("idx", [-1, 16, 17])
def test_layer_step_refuses_an_idx_outside_the_cache(idx):
    """Either version, and the launch on every route, refuse an ``idx`` that
    is no row of the cache before any work: the plain version would attend
    the whole cache unwritten where the kernels poison x_out."""
    fw, (x, kc, vc, ck, cv, mb) = _model_data(4, seed=9, nl=1)
    layer = {k: v[0] for k, v in fw["stacked"].items()}
    args = (x, kc[0], vc[0], ck[0], cv[0], mb, layer, idx)
    with pytest.raises(ValueError, match="no row"):
        dk.fused_layer_step(*args, heads=4)
    for route in (-1, 0, 1, 2):
        with pytest.raises(ValueError, match="no row"):
            dk._launch_layer_step(*args, heads=4, _route=route)
    out, _, _ = dk.fused_layer_step(*args[:-1], 15, heads=4)   # the last row is one
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the work-split model as the sequence kernel and at one layer
# ---------------------------------------------------------------------------


def _sequence_model(fw, ck, cv, mem_bias, *, max_len, start_id, end_id, pad_id=0):
    """The modelled token in the sequence kernel's loop -> tokens [B,
    max_len]: the start token, each token's argmax embedded as the next
    input, a row's done flag set once it emits ``end_id``, the loop left
    after the token at which every row is done (the later positions keep the
    pad fill). The caches are NaN where not yet written: a read of an
    unwritten row would show."""
    nl, _, b, e = ck.shape
    l_pad = dk._round_up8(max_len)
    kc = torch.full((nl, l_pad, b, e), float("nan"))
    vc = torch.full_like(kc, float("nan"))
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32)
    tokens[:, 0] = start_id
    cur, done = tokens[:, 0].clone(), torch.zeros((b,), dtype=torch.bool)
    for j in range(max_len - 1):
        x = dk._embed_step(fw["emb"], fw["pe"], cur, j, pad_id)
        cur, _ = _token_model(x, kc, vc, ck, cv, mem_bias, fw, j, fw["heads"], l_pad)
        tokens[:, j + 1] = cur
        done |= cur == end_id
        if bool(done.all()):
            break
    return tokens


def _chain_gaps(fw, ck, cv, mem_bias, chain, pad_id=0):
    """The plain logits' top-2 gap at every generated position along
    ``chain`` [B, max_len] -> [B, max_len - 1]."""
    nl, _, b, e = ck.shape
    l_pad = dk._round_up8(chain.shape[1])
    ks, vs = torch.zeros((nl, l_pad, b, e)), torch.zeros((nl, l_pad, b, e))
    gaps = []
    for i in range(chain.shape[1] - 1):
        x = dk._embed_step(fw["emb"], fw["pe"], chain[:, i], i, pad_id)
        gaps.append(_plain_gaps(dk._stack_reference(x, ks, vs, ck, cv, mem_bias, fw["stacked"],
                                                    i, fw["heads"], l_pad), fw))
    return torch.stack(gaps, dim=1)


@pytest.mark.parametrize("b", [1, 7, 32])
@pytest.mark.parametrize("ending", ["never", "some_rows", "every_row_at_step_1"])
def test_sequence_work_split_model_matches_plain_version(b, ending):
    """The modelled sequence kernel against ``fused_sequence_decode_reference``:
    the same chain, a row parting only where the plain top-2 gap is below
    1e-4 (and then only from there on)."""
    fw, (_, _, _, ck, cv, mb) = _model_data(b, seed=200 + b)
    kw = dict(heads=fw["heads"], max_len=8, start_id=101, pad_id=0)
    end_id = -1
    if ending == "some_rows":   # the token row 0 emits at position 3
        end_id = int(dk.fused_sequence_decode_reference(fw["emb"], fw["pe"], ck, cv, mb, fw,
                                                        end_id=-1, **kw)[0, 3])
    elif ending == "every_row_at_step_1":
        end_id = 5
        fw = dict(fw, bg=fw["bg"].clone())
        fw["bg"][end_id] = 1e3
    want = dk.fused_sequence_decode_reference(fw["emb"], fw["pe"], ck, cv, mb, fw,
                                              end_id=end_id, **kw)
    got = _sequence_model(fw, ck, cv, mb, max_len=8, start_id=101, end_id=end_id)
    assert got.shape == want.shape == (b, 8) and bool((got[:, 0] == 101).all())
    if ending == "every_row_at_step_1":
        assert got.tolist() == want.tolist() == [[101, end_id] + [0] * 6] * b
        return
    if ending == "some_rows":
        assert bool((want[0, 4:] == 0).all()) if b == 1 else int(want[0, 3]) == end_id
    gaps = _chain_gaps(fw, ck, cv, mb, want)
    for r in (got != want).any(dim=1).nonzero().flatten().tolist():
        first = int((got[r] != want[r]).int().argmax())
        assert float(gaps[r, first - 1]) < GAP, (r, first, got[r], want[r])


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("idx,with_bias", [(0, True), (5, False), (15, True)])
def test_layer_step_work_split_model_matches_plain_version(b, idx, with_bias):
    """The modelled kernel at NL = 1 (what ``fused_layer_step`` launches)
    against ``fused_layer_step_reference``: x_out and the fresh cache rows to
    1e-5 of their largest value."""
    fw, (x, kc, vc, ck, cv, mb) = _model_data(b, seed=300 + b + idx, nl=1, idx=idx)
    mb = mb if with_bias else None
    k1, v1 = kc.clone(), vc.clone()
    _, x_out = _token_model(x, k1, v1, ck, cv, mb, fw, idx, fw["heads"], kc.shape[1])
    layer = {k: v[0] for k, v in fw["stacked"].items()}
    k2, v2 = kc[0].clone(), vc[0].clone()
    x_ref, _, _ = dk.fused_layer_step_reference(x, k2, v2, ck[0], cv[0], mb, layer, idx,
                                                heads=fw["heads"])
    for got, ref in ((x_out, x_ref), (k1[0, idx], k2[idx]), (v1[0, idx], v2[idx])):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(k1[0, :idx], k2[:idx]) and torch.equal(k1[0, idx + 1:], k2[idx + 1:])


def test_layer_by_layer_model_is_the_stack_model():
    """The modelled stack at NL = 2 and the modelled NL = 1 step on each
    layer's weights in turn give the same bits: every product, attention
    and LayerNorm of a layer is formed alike whatever follows it."""
    fw, (x, kc, vc, ck, cv, mb) = _model_data(7, seed=11, idx=6)
    k1, v1 = kc.clone(), vc.clone()
    _, x_stack = _token_model(x, k1, v1, ck, cv, mb, fw, 6, fw["heads"], kc.shape[1])
    k2, v2 = kc.clone(), vc.clone()
    for li in range(kc.shape[0]):
        one = dict(fw, stacked={k: v[li:li + 1] for k, v in fw["stacked"].items()})
        _, x = _token_model(x, k2[li:li + 1], v2[li:li + 1], ck[li:li + 1], cv[li:li + 1], mb,
                            one, 6, fw["heads"], kc.shape[1])
    assert torch.equal(x, x_stack) and torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.parametrize("max_len", [2, 30, dk._MAX_SPAN])
def test_sequence_launch_covers_the_longest_caption(monkeypatch, max_len):
    """What the wrapper hands the launch at B = 32, up to the longest caption
    the kernels span: n_tok = max_len - 1 tokens (one [B] key slot each) from
    position 0, caches of the padded length within the span, the window
    their whole length, tokens [B, max_len] with the start token in column 0
    and the pad fill after it, and the per-token scratch of a window. The
    launch is recorded here instead of made."""
    b, e, f = dk.SEQUENCE_MAX_B, 128, 256
    fw, (_, _, _, ck, cv, mb) = _model_data(b, seed=4, big_l=8)
    pe = torch.zeros((max_len - 1, e))   # positions 0 .. max_len - 2
    seen = {}

    def record(cur, ks, vs, ck_, cv_, mb_, emb, pe_, w, **kw):
        seen.update(kw, cur=cur, ks=ks, pe=pe_)

    monkeypatch.setattr(dk, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(dk, "_launch_multi", record)
    tokens = dk.fused_sequence_decode(fw["emb"], pe, ck, cv, mb, fw, heads=4, max_len=max_len,
                                      start_id=101, end_id=102, pad_id=0)
    l_pad = dk._round_up8(max_len)
    assert seen["cur"] is None and seen["i0"] == 0 and seen["n_tok"] == max_len - 1
    assert seen["seq"] and not seen["poison"] and seen["route"] == -1
    assert seen["ks"].shape == (2, l_pad, b, e) and seen["l_view"] == l_pad <= dk._MAX_SPAN
    assert seen["pe"].shape[0] >= seen["i0"] + seen["n_tok"]
    assert seen["tok_out"] is tokens and tokens.shape == (b, max_len)
    assert tokens[:, 0].tolist() == [101] * b and not bool(tokens[:, 1:].any())
    assert (seen["start_id"], seen["end_id"], seen["pad_id"]) == (101, 102, 0)
    scratch = dk._scratch(b, e, f, "cpu")   # float32 q, r, xf, bfloat16 att, xb, xin, hid, parts
    assert scratch.numel() * 4 >= b * (3 * 4 * e + 3 * 2 * e + 2 * f) + 2 * 64 * e * 2
