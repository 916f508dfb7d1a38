"""CUDA graphs of the port's compiled programs: the decode programs
(``decode_fast.make_fused_*_fn``, ``decode.make_greedy_fn`` /
``make_beam_fn``), the pixels-to-tokens program
(``pipeline.make_video_caption_fn``), the CLIP towers (``StagedModule``,
behind ``serve.py``, ``cli/extract.py`` and ``clip.text.build_text_encoder``)
and the train and validation steps (``train.step``).

The JAX package compiles these programs with ``jax.jit``. Here a program is
a ``Staged`` runner: stages over a state dict, captured as CUDA graphs once
per input shape and replayed (``StagedDecode`` for a decode, whose stages
are ``stage_bounds``' 8 tokens each; ``StagedModule`` for a frozen tower,
one stage). Its pieces:

* ``shape_key`` / ``static_like`` / ``copy_into``: one shape's static input
  buffers, which every call's tensors are copied into (a tensor, ``None``,
  or a dict / list / tuple of those);
* ``side_stream``: where a shape's first call runs eagerly and where its
  graphs are captured;
* ``capture``: one graph into a memory pool, with the random generators it
  draws from registered, so that each replay advances their offsets as an
  eager run would. The kernel wrappers count a launch when they enqueue one,
  which under capture runs nothing: ``capture`` restores the counts, and each
  ``Graph.replay`` adds the launches its capture recorded.

Anything captured must neither copy from host memory nor wait for the device
(``.item()``, ``bool(tensor)``, ``torch.tensor(..., device=cuda)``): the
capture raises, and nothing falls back to an eager run.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

import torch

from vct_tpu_torch import tracing

Counter = Tuple[Callable, str]


def counters() -> List[Counter]:
    """Every kernel wrapper's counter, as (wrapper, attribute)."""
    from vct_tpu_torch.ops import attention_kernels as ak
    from vct_tpu_torch.ops import decode_kernels as dk
    from vct_tpu_torch.ops import embedding_kernels as ek
    from vct_tpu_torch.ops import loss_kernels as lk
    from vct_tpu_torch.ops import moe_kernels as mk

    fns = (*dk.WRAPPERS, *lk.WRAPPERS, *ek.WRAPPERS, *mk.WRAPPERS, ak.fused_attention,
           ak.fused_attention_trainable)
    out = [*((fn, "launches") for fn in fns),
           (ak.fused_attention_trainable, "backward_launches")]
    # the optimizer's update, once an optimizer has imported it (serving and
    # eval import nothing for it)
    optim = sys.modules.get("vct_tpu_torch.ops.optim_kernels")
    if optim is not None:
        out += [(optim.adam_update, "launches"), (optim.adam_update, "elements")]
    return out


def read_counts() -> Dict[Counter, int]:
    return {c: getattr(*c) for c in counters()}


class Graph:
    """A captured CUDA graph and the kernel launches its capture recorded."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launched: Dict[Counter, int]):
        self.graph, self.launched = graph, launched

    def replay(self) -> None:
        """The graph on the caller's stream; its launches join the counts."""
        self.graph.replay()
        for (fn, attr), n in self.launched.items():
            setattr(fn, attr, getattr(fn, attr) + n)


def capture(fn: Callable[[], Any], *, pool, generators: Sequence[torch.Generator] = ()
            ) -> Tuple[Graph, Any]:
    """``fn()`` captured on the current stream (a side stream, not the
    legacy default one) into the memory ``pool`` -> (the graph, what ``fn``
    returned: tensors the replays overwrite). ``generators`` are the CUDA
    generators ``fn`` draws from besides the default one. A failed capture
    raises its own error. The garbage collector is off while it captures:
    a collection there may destroy an unreachable older graph, which the
    card refuses during a capture, and the capture is then invalid (it
    collects after, when it next runs)."""
    before = read_counts()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    collecting = gc.isenabled()
    gc.disable()
    try:
        # thread-local: the server's handler threads go on using the card while
        # one of them captures
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            with contextlib.suppress(Exception):  # the capture is invalid: fn's error counts
                graph.capture_end()
            raise
        else:
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
        after = read_counts()
        for (owner, attr), n in before.items():
            setattr(owner, attr, n)
    return Graph(graph, {c: after[c] - n for c, n in before.items() if after[c] != n}), out


@contextlib.contextmanager
def side_stream(device: torch.device) -> Iterator[torch.cuda.Stream]:
    """A new stream of ``device`` that starts after the caller's work and
    that the caller's stream waits for at the end."""
    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    try:
        with torch.cuda.stream(side):
            yield side
    finally:
        caller.wait_stream(side)


@contextlib.contextmanager
def pool_growth(device: torch.device, into: Dict[str, int]) -> Iterator[None]:
    """``into["bytes"]``: the device memory reserved while the block ran
    (a capture's pool)."""
    reserved = torch.cuda.memory_reserved(device)
    try:
        yield
    finally:
        into["bytes"] = torch.cuda.memory_reserved(device) - reserved


def shape_key(tree) -> Tuple:
    """The structure of ``tree`` with each tensor's (shape, dtype, device):
    two trees with the same key fit the same static buffers."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, shape_key(v)) for k, v in sorted(tree.items()))
    return (type(tree).__name__, tuple(shape_key(v) for v in tree))


def first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor of ``tree`` in ``shape_key``'s order (a runner's
    ``feats``, ``pixels`` or ``tokens``), or None."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    for v in (v for _, v in sorted(tree.items())) if isinstance(tree, dict) else tree:
        t = first_tensor(v)
        if t is not None:
            return t
    return None


def static_like(tree):
    """Uninitialised buffers in the shape of ``tree``."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else torch.empty_like(tree)
    if isinstance(tree, dict):
        return {k: static_like(v) for k, v in tree.items()}
    return type(tree)(static_like(v) for v in tree)


def copy_into(dst, src) -> None:
    """``src``'s tensors into the static buffers ``dst`` (the same key)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k])
    elif dst is not None:
        for d, s in zip(dst, src):
            copy_into(d, s)


def stage_bounds(max_len: int) -> List[Tuple[int, int, int]]:
    """A decode's token loop in stages -> [(first position, end, l_view)]:
    8 tokens each, the self-cache window ``l_view`` growing with them. The
    host tests for the early exit between stages."""
    l_pad = (max_len + 7) // 8 * 8
    bounds, lo = [], 0
    while lo < max_len - 1:
        hi = min(lo + 8, max_len - 1)
        bounds.append((lo, hi, min((hi + 7) // 8 * 8, l_pad)))
        lo = hi
    return bounds


def run_stages(st: dict, stages: List[Callable], call: int = 0) -> dict:
    """``stages`` on the state ``st`` one after another, the host reading
    ``st["all_done"]`` between two of them and stopping once it is set.
    Each stage is a ``graph.stage`` span and each read a ``graph.sync``
    span of the runner's ``call``."""
    for s, stage in enumerate(stages):
        with tracing.span("graph.stage", call=call, stage=s):
            stage(st)
        if s + 1 < len(stages) and _all_done(st, call, s):
            break
    return st


def _all_done(st: dict, call: int, stage: int) -> bool:
    """The host's read of ``st["all_done"]`` after ``stage``: it waits for
    the device to finish the work enqueued so far."""
    with tracing.span("graph.sync", call=call, stage=stage):
        return bool(st["all_done"])


def on_card(inputs: Dict[str, Any]) -> bool:
    """Whether a runner's inputs lie on a card (their first tensor does)."""
    return first_tensor(inputs).is_cuda


class _Set:
    """One input shape's static buffers and, on a card, its CUDA graphs:
    ``inputs`` are what each call's tensors are copied into, ``st`` the
    program's state beside them; graph ``s`` is stage ``s``, kept with the
    state it leaves (a stage may rebind what ``st`` holds: after a replay of
    stage ``s`` the results are in stage ``s``'s tensors, not in the last
    stage's)."""

    def __init__(self, inputs: Dict[str, Any]):
        self.inputs = static_like(inputs)
        self.st = dict(self.inputs)
        self.graphs: List[Tuple[Graph, Dict]] = []
        self.pool_bytes = 0
        self.capture_seconds = 0.0


class Staged:
    """A program split into ``stages`` over a state dict, then ``finish``
    on the state the last stage run left -> the result. Between two stages
    the host reads ``st["all_done"]`` and runs the next only while it is
    false (a decode's early exit); a program of one stage reads nothing.

    Each input shape (``shape_key``) gets a ``_Set``: static buffers the
    call's inputs (a dict of tensors, or of lists of them) are copied into.
    On CPU tensors the stages run on them directly. On CUDA tensors the first call of a shape
    runs the stages on a side stream (which builds the kernel library, sets
    cuBLAS up and, for a train step, makes the optimizer's state) and answers
    from that run, then captures one CUDA graph per stage into one memory
    pool, with ``generators`` registered; every later call replays the
    graphs: the same kernels with the same arguments in the same order, so
    the same bits as the eager run. A failed capture or replay raises;
    nothing falls back to the eager run. ``finish`` must return tensors that
    are the caller's own (clones or new), so a result held across calls is
    not overwritten. One call runs at a time (the buffers are shared).

    ``max_sets`` (None: no bound) caps the shapes kept, in the order last
    used: a new shape past it drops the least recently used one, whose pool
    the allocator frees when it next runs short (or at
    ``torch.cuda.empty_cache``); that shape, seen again, runs eagerly and is
    captured again.

    ``sets``, ``graphs`` and ``replays`` count the shapes set up, the graphs
    captured and the replays, over the runner's life (``reset`` keeps them);
    ``pool_bytes`` and ``capture_seconds`` map each captured shape's key to
    its pool's memory and its capture time.

    Each call is a ``graph.run`` span (ids: ``call``, a new id; ``new``, 1
    for a shape's first call; ``stages``, the runner's stage count), around
    its ``graph.capture`` on a card's first call and each stage's
    ``graph.stage`` and ``graph.sync`` spans (``run_stages``)."""

    max_sets = None

    def __init__(self, stages: List[Callable], finish: Callable,
                 generators: Sequence[torch.Generator] = ()):
        self._stages, self._finish = list(stages), finish
        self.generators = tuple(generators)
        self._sets: Dict = {}
        self._owner: Tuple = ()
        self._lock = threading.Lock()
        self.sets = self.graphs = self.replays = 0

    @property
    def pool_bytes(self) -> Dict:
        return {key: gs.pool_bytes for key, gs in self._sets.items() if gs.graphs}

    @property
    def capture_seconds(self) -> Dict:
        return {key: gs.capture_seconds for key, gs in self._sets.items() if gs.graphs}

    def reset(self) -> None:
        """Drop every shape's buffers and graphs (their pools go with them):
        the next call of each shape runs eagerly and captures again."""
        self._sets.clear()

    def own(self, objects: Tuple, version: Hashable = 0) -> None:
        """Drop the graphs when they were captured for other ``objects``, or
        for another ``version`` of them: a graph reads and writes the
        addresses its capture saw."""
        if (len(objects) + 1 != len(self._owner) or version != self._owner[-1]
                or any(a is not b for a, b in zip(objects, self._owner))):
            self.reset()
            self._owner = (*objects, version)

    def run(self, inputs: Dict[str, Any]):
        key = shape_key(inputs)
        call = tracing.next_id()
        with self._lock:
            gs = self._sets.pop(key, None)  # put back last: the most recently used
            new = gs is None
            with tracing.span("graph.run", call=call, new=int(new), stages=len(self._stages)):
                if new:
                    while self.max_sets is not None and len(self._sets) >= self.max_sets:
                        del self._sets[next(iter(self._sets))]
                    gs = _Set(inputs)
                copy_into(gs.inputs, inputs)
                if new and on_card(inputs):
                    with tracing.span("graph.capture", call=call):
                        out = self._capture(gs, call)
                else:
                    out = self._finish(self._replay(gs, call) if gs.graphs
                                       else run_stages(gs.st, self._stages, call))
            self._sets[key] = gs
            if new:
                self.sets += 1
            return out

    def _capture(self, gs: _Set, call: int):
        dev = first_tensor(gs.inputs).device
        with side_stream(dev):
            state = run_stages(gs.st, self._stages, call)
        out = self._finish(state)  # on the caller's stream, like a replay's
        t0 = time.perf_counter()  # a capture is host work: it runs nothing
        pool = torch.cuda.graph_pool_handle()
        grown: Dict[str, int] = {}
        with side_stream(dev), pool_growth(dev, grown):
            for stage in self._stages:
                def body(stage=stage):
                    stage(gs.st)
                    return dict(gs.st)

                gs.graphs.append(capture(body, pool=pool, generators=self.generators))
                self.graphs += 1
        gs.capture_seconds = time.perf_counter() - t0
        gs.pool_bytes = grown["bytes"]
        return out

    def _replay(self, gs: _Set, call: int) -> Dict:
        """The graphs replayed on the caller's stream -> the state the last
        replayed stage left."""
        for s, (graph, state) in enumerate(gs.graphs):
            with tracing.span("graph.stage", call=call, stage=s):
                graph.replay()
            self.replays += 1
            if s + 1 < len(gs.graphs) and _all_done(state, call, s):
                break
        return state


class StagedDecode(Staged):
    """fn(feats, masks) -> a decode's result, as a ``Staged`` runner under
    ``no_grad``: ``prologue`` (the encoder, the caches or the cross K/V
    layout, the loop's state) then ``stages`` (8 tokens each,
    ``stage_bounds``), the prologue captured with the first stage, then
    ``finish``. The host reads ``st["all_done"]`` after each stage, the early
    exit that the reference's ``lax.while_loop`` condition gives."""

    def __init__(self, prologue: Callable, stages: List[Callable], finish: Callable):
        self.parts = (prologue, stages, finish)

        def first(st):
            prologue(st)
            if stages:
                stages[0](st)

        super().__init__([first, *stages[1:]], finish)

    @torch.no_grad()
    def __call__(self, video_feats, video_masks):
        return self.run({"feats": list(video_feats),
                         "masks": list(video_masks) if video_masks else None})

    def fronted(self, front: Callable) -> "StagedDecode":
        """A new runner of this decode (the same parts, so the same kernel
        weights) whose prologue starts with ``front(st)``: a step that turns
        the runner's own inputs into ``st["feats"]`` / ``st["masks"]`` (the
        pixels-to-tokens program's tower), captured in the first graph, so
        nothing goes back to the host between it and the decoder. It is
        called through ``run`` with those inputs; its graphs and counts are
        its own."""
        prologue, stages, finish = self.parts

        def fronted_prologue(st):
            front(st)
            prologue(st)

        return StagedDecode(fronted_prologue, stages, finish)

    @property
    def runner(self) -> "StagedDecode":
        """Itself, as ``decode.make_auto_*_fn`` results name their runner."""
        return self


class StagedModule(Staged):
    """fn(x) -> ``module(x)`` in float32, as a one-stage ``Staged`` runner
    under ``no_grad`` keyed on x's shape (``x`` is the input ``key``:
    ``pixels`` for a vision tower, ``tokens`` for a text tower): on CUDA
    tensors one CUDA graph per shape, captured after the shape's first
    (eager) call and replayed; on CPU tensors the module itself. The result
    is a clone. The graphs read the module's weights where their capture saw
    them: a module whose weights moved (``.to()``, ``.half()``) drops them.
    It keeps the ``max_sets`` shapes last used: a video's frame count, or
    the extract CLI's last chunk of one, may take any value."""

    max_sets = 4

    def __init__(self, module: torch.nn.Module, key: str):
        super().__init__([self._stage], lambda st: st["out"].clone())
        self.module, self.key = module, key

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.own((self.module,), tuple(p.data_ptr() for p in self.module.parameters()))
        return self.run({self.key: x})

    def _stage(self, st: Dict[str, Any]) -> None:
        st["out"] = self.module(st[self.key]).float()
