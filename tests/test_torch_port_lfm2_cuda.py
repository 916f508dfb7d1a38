"""The routed experts' kernels (``ops/moe_kernels.py``,
``csrc/moe_grouped.cu``) on the card: each against its plain version at the
LFM2-8B-A1B cell's shapes (2,816 tokens, 32 experts, top 4, hidden 2,048,
expert width 1,792), repeated calls bit for bit, the wrappers' refusals, and
a graphed LFM2 train step against the eager step with its launch counts.

The card tests (``-m cuda``) skip where there is no card. The machine with
the card has no JAX, so this file imports only torch and the port:

    python -m pytest --noconftest -m cuda tests/test_torch_port_lfm2_cuda.py

Tolerances: the kernels and the plain versions round at the same points (the
float32 sum of each product rounded once to bfloat16); they sum in another
order, so a bfloat16 output may part by one unit of its last place (2**-8
relative) and a float32 weight gradient by a few units of float32's
(1e-5 of the largest). The routing scores differ only where the kernel's
sigmoid and PyTorch's part in the last place, so the choice may part only at
a tie that close.
"""

import pytest
import torch

from vct_tpu_torch.ops import moe_kernels as mk

T, E, K, H, I = 2816, 32, 4, 2048, 1792
TIE = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _route_inputs(dev, seed=0, t=T, e=E):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn((t, e), generator=g) * 1.4).to(dev)
    bias = (torch.randn(e, generator=g) * 0.05).to(dev)
    return logits, bias


def _near_tie(logits, bias, k):
    score = torch.sigmoid(logits.float()) + bias
    top = score.topk(k + 1, dim=1).values
    return (top[:, k - 1] - top[:, k]) < TIE


@pytest.mark.cuda
def test_route_matches_the_plain_version(cuda):
    logits, bias = _route_inputs(cuda)
    got = mk.moe_route(logits, bias, K)
    want = mk.moe_route_reference(logits, bias, K)
    tie = _near_tie(logits, bias, K)
    same = (got.idx == want.idx).all(dim=1)
    assert bool((same | tie).all())
    # the sort, given the kernel's own choice, is the plain sort's exactly
    sorted_want = mk.route_of(got.idx, E)
    for name in ("dest", "src", "offsets", "counts"):
        assert torch.equal(getattr(got, name), getattr(sorted_want, name)), name
    assert int(got.offsets[-1]) == T * K and int(got.counts.sum()) == T * K
    again = mk.moe_route(logits, bias, K)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _ulps(got, want):
    """Largest distance in units of bfloat16's last place at ``want``'s
    magnitude (floored at 2**-8 of the largest, where small values cancel)."""
    floor = want.float().abs().max() * 2.0 ** -8
    unit = torch.exp2(torch.floor(torch.log2(torch.maximum(want.float().abs(), floor))) - 7)
    return float(((got.float() - want.float()).abs() / unit).max())


@pytest.mark.cuda
def test_grouped_products_match_the_plain_versions(cuda):
    logits, bias = _route_inputs(cuda, seed=1)
    route = mk.moe_route(logits, bias, K)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((T, H), generator=g).to(cuda, torch.bfloat16)
    w13 = (torch.randn((E, 2 * I, H), generator=g) * 0.02).to(cuda, torch.bfloat16)
    w2 = (torch.randn((E, H, I), generator=g) * 0.02).to(cuda, torch.bfloat16)
    gy = torch.randn((T * K, H), generator=g).to(cuda, torch.bfloat16)
    off, src = route.offsets, route.src
    h13 = mk.grouped_forward(x, w13, off, src)
    assert _ulps(h13, mk.grouped_forward_reference(x, w13, off, src)) <= 1.0
    assert torch.equal(h13, mk.grouped_forward(x, w13, off, src))
    act = mk.swiglu(h13)
    y = mk.grouped_forward(act, w2, off)
    assert _ulps(y, mk.grouped_forward_reference(act, w2, off)) <= 1.0
    d_act = mk.grouped_dx(gy, w2, off)
    assert _ulps(d_act, mk.grouped_dx_reference(gy, w2, off)) <= 1.0
    dh = mk.swiglu_backward(h13, d_act)
    d_xs = mk.grouped_dx(dh, w13, off)
    assert _ulps(d_xs, mk.grouped_dx_reference(dh, w13, off)) <= 1.0
    for a, b, bmap in ((gy, act, None), (dh, x, src)):
        got = mk.grouped_dw(a, b, off, bmap)
        want = mk.grouped_dw_reference(a, b, off, bmap)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert torch.equal(got, mk.grouped_dw(a, b, off, bmap))


@pytest.mark.cuda
def test_an_expert_without_rows_gets_a_zero_gradient(cuda):
    logits, bias = _route_inputs(cuda, seed=3, t=300, e=8)
    logits[:, 5] = -30.0   # expert 5 never picked
    route = mk.moe_route(logits, bias, 2)
    assert int(route.counts[5]) == 0
    g = torch.Generator().manual_seed(4)
    a = torch.randn((600, 256), generator=g).to(cuda, torch.bfloat16)
    b = torch.randn((300, 128), generator=g).to(cuda, torch.bfloat16)
    dw = mk.grouped_dw(a, b, route.offsets, route.src)
    assert not dw[5].any()
    want = mk.grouped_dw_reference(a, b, route.offsets, route.src)
    assert float((dw - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    logits, bias = _route_inputs(cuda, t=64, e=8)
    with pytest.raises(ValueError):
        mk.moe_route(logits, bias, 9)
    with pytest.raises(TypeError):
        mk.moe_route(logits.double(), bias, 2)
    route = mk.moe_route(logits, bias, 2)
    a = torch.zeros((64, 256), device=cuda)
    w = torch.zeros((8, 128, 256), device=cuda)
    with pytest.raises(TypeError):
        mk.grouped_forward(a, w, route.offsets, route.src)
    with pytest.raises(ValueError):   # an output width that is no multiple of 128
        mk.grouped_forward(a.bfloat16(), w[:, :96].bfloat16().contiguous(), route.offsets,
                           route.src)


def _lfm2_state(dev, seed=0):
    """A seeded LFM2 captioner at small widths the kernels take (hidden 256,
    expert width 256, 8 experts, top 2; the published layer pattern), bf16,
    the loss kernels on, Adam as the Trainer builds it."""
    from vct_tpu_torch.config import ModelConfig, TPUConfig, TrainConfig
    from vct_tpu_torch.models.lfm2 import caption_lm_config
    from vct_tpu_torch.models.mmt4caption import MMT4Caption
    from vct_tpu_torch.train.optimizers import build_optimizer
    from vct_tpu_torch.train.state import make_train_state

    layer_types = ["conv", "conv", "full_attention", "conv", "conv", "conv"]
    lm = caption_lm_config({
        "model": {"caption_lm": {}}, "model_type": "lfm2_moe", "hidden_size": 256,
        "intermediate_size": 384,
        "moe_intermediate_size": 256, "num_hidden_layers": 6, "layer_types": layer_types,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_dense_layers": 2,
        "num_experts": 8, "num_experts_per_tok": 2, "conv_L_cache": 3, "conv_bias": False,
        "norm_eps": 1e-5, "rope_theta": 1e6, "norm_topk_prob": True,
        "routed_scaling_factor": 1.0, "use_expert_bias": True, "vocab_size": 1024,
        "max_position_embeddings": 4096})
    cfg = ModelConfig.from_dict({
        "modal": ["m0"], "modal_shape": [64], "embed_dim": 128, "dropout": 0.0,
        "vocab_size": 1024, "activation": "gelu",
        "video_encoder": {"layer": 1, "nhead": 4, "feedforward": 256},
        "caption_decoder": {"layer": 1, "nhead": 4, "feedforward": 256}})
    model = MMT4Caption(cfg, TPUConfig(dtype="bfloat16", use_fused_loss=True,
                                       fused_loss_pallas=True), dtype=torch.bfloat16,
                        caption_lm=lm)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    train = TrainConfig.from_dict({"task": "caption", "optimizer": {
        "name": "adam", "learning_rate": 1e-3, "beta": [0.9, 0.999]}})
    return make_train_state(model, build_optimizer(train, model), device=dev, seed=5)


def _lfm2_batch(dev, seed, b=16, s=32):
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((b, s), dtype=torch.int32)
    for r in range(b):
        words = int(torch.randint(4, 21, (1,), generator=g))
        ids[r, 0], ids[r, words + 1] = 101, 102
        ids[r, 1:words + 1] = torch.randint(104, 1024, (words,), generator=g)
    masks = torch.zeros((b, 12), dtype=torch.bool)
    masks[1::3, 8:] = True
    return {"feats": [torch.randn((b, 12, 64), generator=g).to(dev)],
            "masks": [masks.to(dev)], "token_ids": ids.to(dev),
            "token_mask": (ids == 0).to(dev),
            "row_valid": torch.ones(b, dtype=torch.bool, device=dev)}


@pytest.mark.cuda
def test_graphed_lfm2_train_step_replays_the_eager_bits(cuda):
    """Four steps: the graphed runner's first call (eager, then the capture)
    and three replays against the eager step on two copies of the state;
    every parameter, Adam's moments and the metrics by the rule of the
    graphed train tests. Each replay adds, for the 4 MoE layers, 4 routing
    launches, 8 grouped forward, 8 dX and 8 dW launches, and the expert
    choice kept on the card is the replay's."""
    from tests.test_torch_port_cuda import _hold_to_eager, _state_tensors
    from vct_tpu_torch.train.step import make_train_step

    eager_a, eager_b, graphed = (_lfm2_state(cuda) for _ in range(3))
    runner = make_train_step("caption")
    batches = [_lfm2_batch(cuda, s) for s in range(2)]
    moes = graphed.model.cap_decoder.moe_layers()
    for i in range(4):
        batch = batches[i % 2]
        want = _state_tensors(eager_a, runner.eager(eager_a, batch)[1])
        again = _state_tensors(eager_b, runner.eager(eager_b, batch)[1])
        before = [fn.launches for fn in mk.WRAPPERS]
        _, metrics = runner(graphed, batch)
        torch.cuda.synchronize()
        added = [fn.launches - b for fn, b in zip(mk.WRAPPERS, before)]
        assert added == [4, 8, 8, 8], added
        _hold_to_eager(_state_tensors(graphed, metrics), want, again)
        t = 16 * 44
        picked = [m.last_idx[t] for m in eager_a.model.cap_decoder.moe_layers()]
        assert all(torch.equal(m.last_idx[t], p) for m, p in zip(moes, picked))
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 3)


@pytest.mark.cuda
def test_greedy_decode_runs_on_the_card(cuda):
    """The eval decode of the LFM2 caption LM on the card (bf16, the routing
    and grouped kernels at the decode's row counts): the start token first,
    [PAD] once every row has ended, and the prefill's logits those of the
    teacher-forced forward at the start position (the same bf16 products, the
    same experts: within a bf16 unit of the largest logit)."""
    from vct_tpu_torch.decode import make_auto_greedy_fn

    model = _lfm2_state(cuda).model.eval()
    batch = _lfm2_batch(cuda, 7)
    feats, masks = batch["feats"], batch["masks"]
    before = mk.moe_route.launches
    tokens, attn = make_auto_greedy_fn(model, 12, 101, 102)(feats, masks)
    assert attn is None and tokens.shape == (16, 12) and bool((tokens[:, 0] == 101).all())
    assert mk.moe_route.launches > before
    with torch.no_grad():
        lm = model.cap_decoder
        memory, mem_mask, _ = model.encode(feats, masks)
        start = tokens[:, 0]
        first, _ = lm.prefill(memory, mem_mask, start, 12)
        full = lm.logits(lm.hidden(memory, start[:, None].long(), mem_mask))[:, 0]
    scale = float(full.float().abs().max())
    assert float((first.float() - full.float()).abs().max()) <= scale * 2.0 ** -7
