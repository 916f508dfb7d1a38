"""The token embedding's lookup and gradient as a pair of CUDA kernels
(``csrc/embedding.cu``), each beside its plain PyTorch version.

Replaces no TPU kernel: the JAX package's token embedding
(``vct_tpu/models/decoder.py:132-135``, ``jnp.take`` + ``jnp.where``) is plain
XLA. The plain version of the pair, ``embedding_reference``, is the
expression ``CapDecoder.embed`` always had: the table cast to the compute
dtype, the ids' rows gathered, pad positions zeroed. On the card its backward
is ATen's ``index_put_`` with accumulate, which adds the rows of each run of
equal ids one after another, rounding each sum to the compute dtype, so a
caption batch's run of pad ids (about half its positions) takes a
millisecond.

* ``embed_gather(w, ids, pad_id, dtype)``: ``out[n] = w[ids[n]]`` cast to
  ``dtype``, zeros where ``ids[n] == pad_id``; reads only the gathered rows.
* ``embed_grad(g, ids, v, pad_id)``: the float32 ``[V, E]`` gradient of the
  table: every row zero, then each id's rows of ``g`` summed in float32 in
  ascending position and rounded once to ``g``'s dtype; pad positions take
  nothing (their gradient is zero by the forward's definition).
  ``embed_grad_plan`` describes its launches (``vct_embed_grad_plan``),
  ``grad_ranks`` the order its ranking writes. No atomics: the same bits on every
  run, and a graph replay gives the eager call's.
* ``embedding(weight, tokens, pad_id, dtype)``: what ``CapDecoder.embed``
  calls. CPU tensors take ``embedding_reference``; CUDA tensors take the
  kernels through an ``autograd.Function`` or raise (a dtype other than
  float32 and bfloat16, a width that is not a multiple of 8, no ids).

An id outside ``[0, V)`` gathers zeros and takes no gradient on the card (the
plain version raises). Each wrapper counts its calls that launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from vct_tpu_torch.ops._checks import expect as _expect
from vct_tpu_torch.ops._checks import on_cuda as _on_cuda
from vct_tpu_torch.ops._checks import raise_on, stream

CHUNK = 16384        # positions ranked and summed a launch at a time (csrc/embedding.cu)
THREADS = 256        # 8 warps: a position (gather) or a run's 256 columns (sums)
RANK_POSITIONS = 32  # positions a ranking block ranks (a warp 4)
FILL_BLOCKS = 528    # blocks of the rank launch that zero the table gradient
MAX_BLOCKS = 1056    # the sums' grid at most
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def embedding_reference(weight: torch.Tensor, tokens: torch.Tensor, pad_id: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """[...] ids -> [..., E] in ``dtype``; pad tokens embed to zero. A
    float32 table's rows are taken by ``index_select``: the same values,
    and a gradient that adds each position's row in ascending order
    (``index_add_``), where indexing's (``index_put_`` with accumulate) adds
    float32 rows with atomics in no fixed order on the host from 32,768
    elements and more than one thread; in other dtypes it adds in order."""
    w = weight.to(dtype)
    if w.dtype == torch.float32:
        emb = w.index_select(0, tokens.reshape(-1).long()).view(*tokens.shape, w.shape[1])
    else:
        emb = w[tokens.long()]
    return emb.masked_fill((tokens == pad_id)[..., None], 0.0)


def embed_gather_reference(w, ids, pad_id: int, dtype) -> torch.Tensor:
    return embedding_reference(w.detach(), ids, pad_id, dtype)


def embed_grad_reference(g, ids, v: int, pad_id: int) -> torch.Tensor:
    """The kernel's sums by ``index_add_`` in float32 (on the CPU in ascending
    position, as the kernel adds; on the card in no fixed order), rounded once
    to ``g``'s dtype."""
    keep = (ids != pad_id) & (ids >= 0) & (ids < v)
    out = torch.zeros((v, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, ids[keep].long(), g[keep].float())
    return out.to(g.dtype).float()


# ---------------------------------------------------------------------------
# the gradient's launch plan and the runs its sort writes
# ---------------------------------------------------------------------------


class GradPlan(NamedTuple):
    """How ``csrc/embedding.cu`` launches ``embed_grad``, field for field what
    ``vct_embed_grad_plan`` reports: ``chunks`` chunks of at most ``chunk``
    positions, in order; for each, ``rank_blocks`` blocks of ``threads``
    rank its positions, ``RANK_POSITIONS`` a block (the first chunk's count;
    its launch adds ``fill_blocks`` that zero the table), then
    ``accum_blocks`` blocks (the first chunk's) sum its runs, a warp for each
    (run, 256 columns);
    ``round_blocks`` x ``chunks`` blocks round the touched rows after the
    last chunk (0: each chunk's sums are rounded as they are stored);
    ``scratch_ints`` int32 of scratch."""
    chunk: int
    chunks: int
    rank_blocks: int
    fill_blocks: int
    accum_blocks: int
    threads: int
    round_blocks: int
    scratch_ints: int


def chunk_sizes(n: int) -> List[int]:
    """The positions of each chunk, in the order the chunks run."""
    return [min(CHUNK, n - c0) for c0 in range(0, n, CHUNK)]


def _accum_blocks(nc: int, e: int) -> int:
    warps = nc * -(-e // 256)   # one a (position, 256 columns); a run's first one sums it
    return min(-(-warps // (THREADS // 32)), MAX_BLOCKS)


def embed_grad_plan(n: int, e: int, dtype) -> GradPlan:
    """The launches of ``embed_grad`` for ``n`` positions of width ``e`` in
    ``dtype`` (a description for tests and readers, not on the launch path).
    With more than one chunk the bfloat16 sums are rounded by a last kernel,
    once every chunk has added its part; float32 rounds nothing."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}; the kernels take float32 or bfloat16")
    if n < 1 or e < 8 or e % 8:
        raise ValueError(f"N={n}, width {e}: N >= 1 and a width that is a multiple of 8")
    chunks = len(chunk_sizes(n))
    first = min(n, CHUNK)
    round_blocks = _accum_blocks(CHUNK, e) if chunks > 1 and dtype == torch.bfloat16 else 0
    return GradPlan(CHUNK, chunks, -(-first // RANK_POSITIONS), FILL_BLOCKS,
                    _accum_blocks(first, e), THREADS, round_blocks, 2 * n + chunks)


class Ranked(NamedTuple):
    """One chunk as ``embed_rank_kernel`` leaves it: ``perm`` its non-pad
    positions sorted by (id, position), ``ids`` the id of each. A run is a
    stretch of equal ids; the sums start at each run's first index."""
    perm: List[int]
    ids: List[int]


def grad_ranks(ids, pad_id: int, v: int) -> List[Ranked]:
    """Each chunk of ``ids`` (a 1-D sequence) sorted as the rank kernel
    sorts it: the model the tests hold the launch layout to."""
    ids = [int(i) for i in ids]
    out, c0 = [], 0
    for nc in chunk_sizes(len(ids)):
        keys = sorted((i, c0 + k) for k, i in enumerate(ids[c0:c0 + nc])
                      if i != pad_id and 0 <= i < v)
        out.append(Ranked([p for _, p in keys], [i for i, _ in keys]))
        c0 += nc
    return out


# ---------------------------------------------------------------------------
# checks and the CUDA launches
# ---------------------------------------------------------------------------


def _check_ids(ids, n: int, device) -> None:
    if n < 1:
        raise ValueError(f"ids of shape {tuple(ids.shape)}: a non-empty vector")
    _expect(ids, "ids", (n,), torch.int32, device, vector_loads=False)


def _check_width(e: int) -> None:
    if e < 8 or e % 8:
        raise ValueError(f"width {e} must be a multiple of 8 (16-byte row slices)")


def _launch_gather(w, ids, pad_id: int, dtype) -> torch.Tensor:
    from vct_tpu_torch.ops._build import load_library

    for name, dt in (("w", w.dtype), ("dtype", dtype)):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"{name} {dt}; the kernels take float32 or bfloat16")
    v, e = w.shape
    _check_width(e)
    n = ids.shape[0] if ids.ndim == 1 else 0
    _check_ids(ids, n, w.device)
    _expect(w, "w", (v, e), w.dtype, w.device)
    out = torch.empty((n, e), dtype=dtype, device=w.device)
    with torch.cuda.device(w.device):
        err = load_library().vct_embed_gather(
            _DTYPE_CODE[w.dtype], _DTYPE_CODE[dtype], w.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n, v, e, pad_id, stream(w.device))
    raise_on(err, "vct_embed_gather")
    return out


def _launch_grad(g, ids, v: int, pad_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the gradient, the int32 scratch the ranking wrote)."""
    from vct_tpu_torch.ops._build import load_library

    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"g has dtype {g.dtype}; the kernels take float32 or bfloat16")
    n, e = g.shape
    _check_width(e)
    _check_ids(ids, n, g.device)
    _expect(g, "g", (n, e), g.dtype, g.device)
    plan = embed_grad_plan(n, e, g.dtype)
    out = torch.empty((v, e), dtype=torch.float32, device=g.device)
    scratch = torch.empty((plan.scratch_ints,), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = load_library().vct_embed_grad(
            _DTYPE_CODE[g.dtype], g.data_ptr(), ids.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, v, e, pad_id, stream(g.device))
    raise_on(err, "vct_embed_grad")
    return out, scratch


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def embed_gather(w, ids, pad_id: int, dtype) -> torch.Tensor:
    """``w`` [V, E] float32 or bfloat16, ``ids`` [N] int32 -> [N, E] in
    ``dtype``."""
    if not _on_cuda(w, "embed_gather"):
        return embed_gather_reference(w, ids, pad_id, dtype)
    out = _launch_gather(w, ids, pad_id, dtype)
    embed_gather.launches += 1
    return out


def embed_grad(g, ids, v: int, pad_id: int) -> torch.Tensor:
    """``g`` [N, E] float32 or bfloat16, ``ids`` [N] int32 -> [V, E]
    float32."""
    if not _on_cuda(g, "embed_grad"):
        return embed_grad_reference(g, ids, v, pad_id)
    out = _launch_grad(g, ids, v, pad_id)[0]
    embed_grad.launches += 1
    return out


embed_gather.launches = 0
embed_grad.launches = 0
WRAPPERS = (embed_gather, embed_grad)


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, ids, pad_id, dtype):
        ctx.save_for_backward(ids)
        ctx.pad_id, ctx.table = pad_id, (weight.shape[0], weight.dtype)
        return embed_gather(weight, ids, pad_id, dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        v, w_dtype = ctx.table
        return embed_grad(g.contiguous(), ids, v, ctx.pad_id).to(w_dtype), None, None, None


def embedding(weight: torch.Tensor, tokens: torch.Tensor, pad_id: int,
              dtype: torch.dtype) -> torch.Tensor:
    """``weight`` [V, E], ``tokens`` [...] ids -> [..., E] in ``dtype``; pad
    tokens embed to zero and take no gradient."""
    if not _on_cuda(weight, "embedding"):
        return embedding_reference(weight, tokens, pad_id, dtype)
    ids = tokens.reshape(-1).to(torch.int32).contiguous()
    out = _Embedding.apply(weight, ids, pad_id, dtype)
    return out.view(*tokens.shape, weight.shape[1])
