"""The token embedding's kernel pair (``ops/embedding_kernels.py``,
``csrc/embedding.cu``): its plain path, its launch plan and the runs its sort
writes on the host; the kernels against ATen's path and a float64 sum on the
card.

The card tests (``-m cuda``) skip where there is no card. The machine with
the card has no JAX, so this file imports only torch and the port:

    python -m pytest --noconftest -m cuda tests/test_torch_port_embedding.py

Their ids are laid out as the train cell's batches: rows of 31 positions
(the MSVD recipe's 32-token captions less one) holding ``[CLS]``, 4-20 words
drawn from a few thousand frequent ids (so many ids repeat) and ``[SEP]``,
pads after; N = 1984 is 64 such rows, N = 4096 the long-video recipe's 32 x
128, N = 20000 more than one sorted chunk.
"""

import numpy as np
import pytest
import torch

from vct_tpu_torch.ops import embedding_kernels as ek

PAD, CLS, SEP = 0, 101, 102
V, E = 30522, 768


def _ids(n: int, row: int, seed: int, v: int = V) -> torch.Tensor:
    """[n] int32 in rows of ``row`` positions: [CLS], 4-20 words (at most
    row - 2), [SEP], pads."""
    rng = np.random.default_rng(seed)
    ids = np.zeros(n, dtype=np.int32)
    for r0 in range(0, n, row):
        width = min(row, n - r0)
        words = int(rng.integers(4, 21))
        words = min(words, max(width - 2, 0))
        ids[r0] = CLS
        ids[r0 + 1:r0 + 1 + words] = rng.integers(1000 if v > 4000 else 5, min(4000, v),
                                                  size=words)
        if words + 1 < width:
            ids[r0 + 1 + words] = SEP
    return torch.from_numpy(ids)


# ---------------------------------------------------------------------------
# on the host: the plain path, the plan and the runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_expression(dtype):
    """``embedding`` on CPU tensors is ``CapDecoder.embed``'s old expression,
    forward and gradient, bit for bit, and launches nothing."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn((300, 64), generator=g)
    tokens = _ids(4 * 31, 31, seed=4, v=300).view(4, 31)
    grad = torch.randn((4, 31, 64), generator=g).to(dtype)
    before = (ek.embed_gather.launches, ek.embed_grad.launches)

    w1 = w.clone().requires_grad_(True)
    out = ek.embedding(w1, tokens, PAD, dtype)
    out.backward(grad)
    w2 = w.clone().requires_grad_(True)
    old = w2.to(dtype)[tokens.long()].masked_fill((tokens == PAD)[..., None], 0.0)
    old.backward(grad)

    assert out.dtype == dtype and out.shape == (4, 31, 64)
    assert torch.equal(out, old)
    assert torch.equal(w1.grad, w2.grad)
    assert (ek.embed_gather.launches, ek.embed_grad.launches) == before


def test_cap_decoder_embeds_through_the_wrapper():
    from vct_tpu_torch.models.decoder import CapDecoder

    dec = CapDecoder(1, 32, 2, 64, 50, pad_id=PAD, dtype=torch.bfloat16)
    torch.nn.init.normal_(dec.tgt_to_emb.weight)
    tokens = torch.tensor([[CLS % 50, 7, 9, 7, 0, 0]], dtype=torch.int32)
    want = ek.embedding_reference(dec.tgt_to_emb.weight, tokens, PAD, torch.bfloat16)
    assert torch.equal(dec.embed(tokens), want)
    assert not dec.embed(tokens)[0, 4:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_gradient_sums_in_ascending_position_and_rounds_once(dtype):
    """``embed_grad_reference`` on the host: each id's rows added in float32
    in ascending position from zero (the kernel's order), rounded once; pads
    take nothing; rows of ids seen once are the incoming rows."""
    g = torch.Generator().manual_seed(5)
    ids = _ids(8 * 31, 31, seed=6, v=2000)
    ids[::7] = 1500  # a long run
    grad = torch.randn((ids.shape[0], 16), generator=g).to(dtype)
    got = ek.embed_grad(grad, ids, 2000, PAD)
    want = torch.zeros((2000, 16), dtype=torch.float32)
    for pos, i in enumerate(ids.tolist()):
        if i != PAD:
            want[i] += grad[pos].float()
    assert torch.equal(got, want.to(dtype).float())
    assert not got[PAD].any()
    seen = {}
    for pos, i in enumerate(ids.tolist()):
        seen.setdefault(i, []).append(pos)
    for i, where in seen.items():
        if i != PAD and len(where) == 1:
            assert torch.equal(got[i], grad[where[0]].float())


def _runs(chunk: ek.Ranked):
    """(id, its positions in ascending order) of each run of a ranked chunk."""
    out = []
    for k, i in enumerate(chunk.ids):
        if k == 0 or chunk.ids[k - 1] != i:
            out.append((i, []))
        out[-1][1].append(chunk.perm[k])
    return out


@pytest.mark.parametrize("n", [1, 31, 1984, 4096, 20000])
def test_launch_layout_puts_every_non_pad_position_in_one_run(n):
    """The plan's chunks and grids, and the order the ranking writes
    (``grad_ranks``, the model of ``embed_rank_kernel``): every non-pad
    position in exactly one run of its chunk, a run's positions ascending and
    of one id, a chunk's runs of distinct ids, a ranking block for every 32
    positions and a warp for every (position, 256 columns)."""
    ids = _ids(n, 31 if n < 4096 else 128, seed=n)
    sizes = ek.chunk_sizes(n)
    assert len(sizes) == -(-n // ek.CHUNK) and sum(sizes) == n
    assert all(0 < nc <= ek.CHUNK for nc in sizes)
    for dtype in (torch.bfloat16, torch.float32):
        plan = ek.embed_grad_plan(n, E, dtype)
        assert plan.chunks == len(sizes) and plan.threads == ek.THREADS
        per = ek.RANK_POSITIONS
        assert plan.rank_blocks * per >= sizes[0] > (plan.rank_blocks - 1) * per
        warps = plan.accum_blocks * plan.threads // 32
        assert warps >= min(sizes[0] * E // 256, ek.MAX_BLOCKS * plan.threads // 32)
        assert plan.round_blocks == (ek.MAX_BLOCKS if n > ek.CHUNK and
                                     dtype == torch.bfloat16 else 0)
        assert plan.scratch_ints == 2 * n + plan.chunks
    ranked = ek.grad_ranks(ids, PAD, V)
    assert len(ranked) == len(sizes)
    seen, c0 = [], 0
    for chunk, nc in zip(ranked, sizes):
        assert len(chunk.perm) == len(chunk.ids) == sum(int(i) != PAD for i in ids[c0:c0 + nc])
        runs = _runs(chunk)
        assert len({i for i, _ in runs}) == len(runs)
        for run_id, where in runs:
            assert where == sorted(where)
            assert all(c0 <= p < c0 + nc and int(ids[p]) == run_id for p in where)
            seen.extend(where)
        c0 += nc
    assert sorted(seen) == [p for p in range(n) if int(ids[p]) != PAD]
    assert len(seen) == len(set(seen))


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        ek.embed_grad_plan(10, E, torch.float16)
    for n, e in ((0, E), (10, 12), (10, 0)):
        with pytest.raises(ValueError):
            ek.embed_grad_plan(n, e, torch.bfloat16)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CASES = [(1984, 31), (4096, 128)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _table(dev, w_dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((V, E), generator=g) * 0.05).to(dev, w_dtype)


def _grad_in(dev, ids, dtype, seed):
    """The incoming gradient: zero at pads, as ``masked_fill``'s backward
    leaves it."""
    g = torch.Generator().manual_seed(seed)
    grad = torch.randn((ids.shape[0], E), generator=g)
    grad[(ids == PAD).cpu()] = 0
    return grad.to(dev, dtype)


def _aten_grad(w, ids, grad, dtype):
    """The gradient by the path the kernels replace (``index_put_`` with
    accumulate, then the cast back)."""
    w = w.detach().clone().requires_grad_(True)
    ek.embedding_reference(w, ids, PAD, dtype).backward(grad)
    return w.grad


@pytest.mark.cuda
@pytest.mark.parametrize("n,row", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_gather_equals_the_plain_expression(cuda, n, row, dtype, w_dtype):
    ids = _ids(n, row, seed=n).to(cuda)
    w = _table(cuda, w_dtype)
    before = ek.embed_gather.launches
    got = ek.embed_gather(w, ids, PAD, dtype)
    torch.cuda.synchronize()
    assert ek.embed_gather.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, ek.embedding_reference(w, ids, PAD, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n,row", CASES + [(20000, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gradient_against_aten_and_float64(cuda, n, row, dtype):
    """Rows of ids seen once: ATen's backward bit for bit. Repeated ids:
    within one unit of the compute dtype of the float64 sum rounded once
    (float32: within the float32 summation bound). The pad row and untouched
    rows: exactly 0. Two runs: the same bits."""
    ids = _ids(n, row, seed=n + 1).to(cuda)
    grad = _grad_in(cuda, ids, dtype, seed=n)
    before = ek.embed_grad.launches
    got = ek.embed_grad(grad, ids, V, PAD)
    again = ek.embed_grad(grad, ids, V, PAD)
    aten = _aten_grad(_table(cuda), ids, grad, dtype)
    torch.cuda.synchronize()
    assert ek.embed_grad.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (V, E)
    assert torch.equal(got, again)

    counts = torch.bincount(ids.long(), minlength=V)
    counts[PAD] = 0
    once, many = counts == 1, counts > 1
    assert torch.equal(got[once], aten[once])
    assert not got[counts == 0].any() and not got[PAD].any()

    sum64 = torch.zeros((V, E), dtype=torch.float64, device=cuda)
    keep = ids != PAD
    sum64.index_add_(0, ids[keep].long(), grad[keep].double())
    abs64 = torch.zeros_like(sum64).index_add_(0, ids[keep].long(), grad[keep].double().abs())
    err = (got[many].double() - sum64[many]).abs()
    if dtype == torch.bfloat16:
        unit = torch.exp2(torch.floor(torch.log2(sum64[many].abs().clamp(min=1e-30))) - 7)
        assert bool((err <= unit).all()), float((err / unit).max())
    else:
        bound = counts[many].double()[:, None] * 2.0 ** -24 * abs64[many]
        assert bool((err <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,row", CASES + [(20000, 100)])
def test_ranking_writes_the_model_order_and_the_plan_is_the_launcher(cuda, n, row):
    import ctypes

    from vct_tpu_torch.ops._build import load_library

    ids = _ids(n, row, seed=n + 2).to(cuda)
    grad = _grad_in(cuda, ids, torch.bfloat16, seed=1)
    _, scratch = ek._launch_grad(grad, ids, V, PAD)
    scratch = scratch.cpu().tolist()
    ranked = ek.grad_ranks(ids.cpu(), PAD, V)
    perm, sorted_ids, n_real = scratch[:n], scratch[n:2 * n], scratch[2 * n:]
    for c, want in enumerate(ranked):
        c0 = c * ek.CHUNK
        assert n_real[c] == len(want.perm)
        assert perm[c0:c0 + len(want.perm)] == want.perm
        assert sorted_ids[c0:c0 + len(want.ids)] == want.ids
    for dtype in DTYPES:
        out = (ctypes.c_int * 8)()
        assert load_library().vct_embed_grad_plan(ek._DTYPE_CODE[dtype], n, E, out) == 0
        assert tuple(out) == tuple(ek.embed_grad_plan(n, E, dtype))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w = _table(cuda)
    ids = _ids(62, 31, seed=0).to(cuda)
    with pytest.raises(TypeError):
        ek.embed_gather(w, ids, PAD, torch.float16)
    with pytest.raises(TypeError):
        ek.embed_gather(w, ids.long(), PAD, torch.bfloat16)
    with pytest.raises(ValueError):
        ek.embed_gather(w[:, :12].contiguous(), ids, PAD, torch.bfloat16)
    with pytest.raises(ValueError):
        ek.embed_grad(torch.zeros((61, E), device=cuda), ids, V, PAD)
    with pytest.raises(ValueError):
        ek.embed_gather(w, ids[:0], PAD, torch.bfloat16)


def _cell_batch(dev, seed, b=64, s=32):
    """A train batch as the cell's: 64 captions of 32 slots ([CLS], 4-20
    words, [SEP], pads), 12 frame slots of 64-wide features."""
    from tests.test_torch_port_cuda import TRAIN_V

    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros((b, s), dtype=torch.int32)
    for r in range(b):
        words = int(torch.randint(4, 21, (1,), generator=g))
        ids[r, 0], ids[r, words + 1] = 2, 3
        ids[r, 1:words + 1] = torch.randint(5, 200, (words,), generator=g)
    masks = torch.zeros((b, 12), dtype=torch.bool)
    masks[1::3, 8:] = True
    return {"feats": [torch.randn((b, 12, 64), generator=g).to(dev)],
            "masks": [masks.to(dev)], "token_ids": ids.clamp(max=TRAIN_V - 1).to(dev),
            "token_mask": (ids == 0).to(dev), "row_valid": torch.ones(b, dtype=torch.bool,
                                                                    device=dev)}


@pytest.mark.cuda
def test_graphed_train_step_replays_the_pair_with_the_eager_bits(cuda):
    """Four steps of the caption task at N = 64 x 31: the graphed runner's
    first call (eager, then the capture) and three replays against the eager
    step on two copies of the state. The embedding's parameter and its Adam
    moments equal the eager step's bit for bit (and the eager step repeats
    itself); every other tensor by the rule of the graphed train tests. Each
    call adds one gather and one gradient launch."""
    from tests.test_torch_port_cuda import _hold_to_eager, _state_tensors, _train_state
    from vct_tpu_torch.train.step import make_train_step

    eager_a, eager_b, graphed = (_train_state(cuda, "adam") for _ in range(3))
    runner = make_train_step("caption")
    batches = [_cell_batch(cuda, s) for s in range(2)]
    for i in range(4):
        batch = batches[i % 2]
        want = _state_tensors(eager_a, runner.eager(eager_a, batch)[1])
        again = _state_tensors(eager_b, runner.eager(eager_b, batch)[1])
        before = (ek.embed_gather.launches, ek.embed_grad.launches)
        _, metrics = runner(graphed, batch)
        torch.cuda.synchronize()
        assert (ek.embed_gather.launches - before[0], ek.embed_grad.launches - before[1]) == (1, 1)
        got = _state_tensors(graphed, metrics)
        table = [k for k in want if "tgt_to_emb" in k]  # the weight, Adam's step and moments
        assert len(table) == 4
        for k in table:
            assert torch.equal(again[k], want[k]) and torch.equal(got[k], want[k]), k
        _hold_to_eager(got, want, again)
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 3)
