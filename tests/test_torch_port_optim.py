"""The one-pass Adam update (``ops/optim_kernels.py``, ``csrc/adam_update.cu``)
and the optimizers that run it (``train/optimizers.py``): on the host its
plain version against torch's Adam and AdamW, the state and checkpoint layout
torch keeps, the refusals and the launch plan; on the card the kernel
against torch's capturable multi-tensor Adam and AdamW at small, MSVD and
stacked-expert sizes, its plan, its refusals, and the graphed train step.

The card tests (``-m cuda``) skip where there is no card. The machine with
the card has no JAX, so this file imports only torch and the port:

    python -m pytest --noconftest -m cuda tests/test_torch_port_optim.py

Tolerances are in float32 units in the last place (ulp) at the scale of the
step: the spacing of float32 at the larger of the value after the step and
the step's change, so that a value the step moves across zero is measured
against the numbers that were added, not against its small remainder.
Each of the five steps starts the reference from the state under test, so a
step's rounding is not carried into the next.

The host's yardstick is torch's tensor-step branch of Adam (the branch its
``capturable`` update runs on a card, taken on the host with
``differentiable=True``): like the capturable multi-tensor update, and the
kernel, it raises the betas to the step in float32. torch's default host
update raises them in float64; float32's 0.999 is 1.3e-8 off, which moves
the first step's ``sqrt(1 - b2^t)`` by 6.4e-6 of itself: tens to hundreds of
ulp of an update, the same on the card before this kernel.
"""

import copy
from pathlib import Path

import pytest
import torch

from vct_tpu_torch.ops import optim_kernels as ok
from vct_tpu_torch.train import optimizers as po

LR, BETAS, WD = 1e-3, (0.9, 0.999), 0.01
KINDS = {"adam": (po.Adam, torch.optim.Adam, {}),
         "adamw": (po.AdamW, torch.optim.AdamW, {"weight_decay": WD})}


def _spacing(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).double()


def _ulps(got: torch.Tensor, want: torch.Tensor, before: torch.Tensor) -> float:
    """The largest |got - want| in float32 ulp at the larger of |want| and
    |want - before| (see the module's docstring)."""
    scale = _spacing(torch.maximum(want.abs(), (want - before).abs()))
    return float(((got.double() - want.double()).abs() / scale).max())


def _small_params(seed: int):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.LayerNorm(32),
                                torch.nn.Linear(32, 7))
    return [p.detach().clone() for p in model.parameters()]


def _hold_steps(ours, theirs, ps, qs, grads, tol):
    """Five steps of ``ours`` over ``ps`` and ``theirs`` over ``qs``, each from
    ``ours``' state: p, m and v within ``tol`` ulp (see ``_ulps``), steps
    equal. ``grads(i)`` gives step i's gradients."""
    worst = 0.0
    for i in range(5):
        for p, q, g in zip(ps, qs, grads(i)):
            q.copy_(p)
            p.grad, q.grad = g, g
            if ours.state.get(p):
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    theirs.state[q][k].copy_(ours.state[p][k])
        before = {id(q): [q.clone()] + ([theirs.state[q]["exp_avg"].clone(),
                                         theirs.state[q]["exp_avg_sq"].clone()]
                                        if theirs.state.get(q) else
                                        [torch.zeros_like(q), torch.zeros_like(q)])
                  for q in qs}
        ours.step()
        theirs.step()
        for p, q in zip(ps, qs):
            got, want = ours.state[p], theirs.state[q]
            assert float(got["step"]) == float(want["step"]) == i + 1
            for a, b, b0 in zip((p, got["exp_avg"], got["exp_avg_sq"]),
                                (q, want["exp_avg"], want["exp_avg_sq"]), before[id(q)]):
                worst = max(worst, _ulps(a, b, b0))
    assert worst <= tol, worst
    return worst


# ---------------------------------------------------------------------------
# on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_update_against_torch_over_five_steps(kind):
    ours_cls, torch_cls, kw = KINDS[kind]
    ps, qs = _small_params(0), _small_params(0)
    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen) for p in ps] for _ in range(5)]
    ours = ours_cls(ps, lr=LR, betas=BETAS, **kw)
    theirs = torch_cls(qs, lr=LR, betas=BETAS, differentiable=True, **kw)
    _hold_steps(ours, theirs, ps, qs, lambda i: grads[i], 2.0)
    assert ok.adam_update.launches == 0 and ok.adam_update.elements == 0  # the host


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_state_dict_layout_and_checkpoints_load_both_ways(kind):
    """The port's ``state_dict`` has torch's keys, shapes and dtypes; a
    checkpoint of either loads into the other, and a loaded optimizer steps
    as the one it came from, bit for bit."""
    ours_cls, torch_cls, kw = KINDS[kind]
    ps, qs = _small_params(2), _small_params(2)
    ours = ours_cls(ps, lr=LR, betas=BETAS, **kw)
    theirs = torch_cls(qs, lr=LR, betas=BETAS, **kw)
    for opt, ts in ((ours, ps), (theirs, qs)):
        for t in ts:
            t.grad = torch.ones_like(t)
        opt.step()
    a, b = ours.state_dict(), theirs.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, st in a["state"].items():
        assert st.keys() == b["state"][i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in st.items():
            assert (v.shape, v.dtype, v.device) == (b["state"][i][k].shape,
                                                     b["state"][i][k].dtype,
                                                     b["state"][i][k].device)
    # ours -> torch, torch -> ours
    into_torch = torch_cls([p.clone() for p in ps], lr=LR, betas=BETAS, **kw)
    into_torch.load_state_dict(copy.deepcopy(a))  # as from a file: no tensor shared
    into_ours = ours_cls([q.clone() for q in qs], lr=LR, betas=BETAS, **kw)
    into_ours.load_state_dict(copy.deepcopy(b))
    for loaded, src in ((into_torch, a), (into_ours, b)):
        for i, st in loaded.state_dict()["state"].items():
            for k, v in st.items():
                assert torch.equal(v, src["state"][i][k])
    # a loaded port optimizer resumes the port's run bit for bit
    resumed_ps = [p.clone() for p in ps]
    resumed = ours_cls(resumed_ps, lr=LR, betas=BETAS, **kw)
    resumed.load_state_dict(copy.deepcopy(a))
    gen = torch.Generator().manual_seed(3)
    for opt, ts in ((ours, ps), (resumed, resumed_ps)):
        gen.manual_seed(3)
        for _ in range(2):
            for t in ts:
                t.grad = torch.randn(t.shape, generator=gen)
            opt.step()
    for p, r in zip(ps, resumed_ps):
        assert torch.equal(p, r)


@pytest.mark.parametrize("flag", ["amsgrad", "maximize", "l2_decay"])
def test_refuses_what_the_update_does_not_run(flag):
    ps = _small_params(0)
    kw = {"weight_decay": WD} if flag == "l2_decay" else {flag: True}
    with pytest.raises(ValueError, match="amsgrad|maximize|L2"):
        po.Adam(ps, lr=LR, **kw)
    opt = po.AdamW(ps, lr=LR)  # a loaded group may bring the setting along
    if flag == "l2_decay":
        opt.param_groups[0]["decoupled_weight_decay"] = False
    else:
        opt.param_groups[0][flag] = True
    for p in ps:
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError):
        opt.step()


def test_build_optimizer_builds_the_one_pass_classes():
    from vct_tpu_torch.config import TrainConfig

    model = torch.nn.Linear(4, 3)
    for name, wd, cls in (("adam", 0.0, po.Adam), ("adam", WD, po.AdamW),
                          ("adamw", WD, po.AdamW)):
        cfg = TrainConfig.from_dict({"task": "caption", "optimizer": {
            "name": name, "learning_rate": LR, "beta": list(BETAS), "weight_decay": wd}})
        opt = po.build_optimizer(cfg, model)
        assert type(opt) is cls and isinstance(opt, torch.optim.Adam)
        assert isinstance(opt.param_groups[0]["lr"], float)
        assert opt.param_groups[0]["capturable"] is False


@pytest.mark.parametrize("numels", [[1, 3, 4097, 2 ** 20 + 5],
                                    [32 * 3584 * 2048, 32 * 2048 * 1792, 2048, 65536 * 2048],
                                    [768] * 75 + [5]], ids=["small", "stacked", "many"])
def test_split_takes_every_unit_once_and_evenly(numels):
    """Each block's tiles, in turn over the units end to end, cover every
    unit once, and the blocks' tile counts are at most one apart."""
    units = sum(-(-n // 4) for n in numels)
    blocks = ok.update_blocks(units, 132)
    assert 1 <= blocks <= 132 * ok.BLOCKS_PER_SM
    tiles = [ok.block_tiles(units, blocks, b) for b in range(blocks)]
    covered = sorted(r for t in tiles for r in t)
    assert covered[0][0] == 0 and covered[-1][1] == units
    assert all(r[1] == s[0] for r, s in zip(covered, covered[1:]))
    counts = [len(t) for t in tiles]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert ok.update_blocks(1, 132) == 1 and ok.update_blocks(10 ** 9, 132) == 264


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _msvd_shapes():
    """The trainable parameters' shapes of the MSVD recipe (caption task),
    from the model built on the meta device."""
    import dataclasses

    from vct_tpu_torch import config as C
    from vct_tpu_torch.models.mmt4caption import MMT4Caption
    from vct_tpu_torch.train.optimizers import freeze_labels

    cfg = C.load_config(str(Path(__file__).resolve().parent.parent / "configs" / "msvd.json"))
    model = MMT4Caption(dataclasses.replace(cfg.model, vocab_size=30522), cfg.tpu,
                        dtype=torch.bfloat16, device=torch.device("meta"))
    labels = freeze_labels(model, cfg.train.task)
    return [tuple(p.shape) for n, p in model.named_parameters() if labels[n] == "train"]


def _card_params(shapes, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev) * 0.05 for s in shapes]


SIZES = {"small": lambda: [(1,), (3,), (4097,), (2 ** 20 + 5,)],
         "msvd": _msvd_shapes,
         "stacked": lambda: [(32, 3584, 2048)]}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_kernel_against_torch_capturable_adam(cuda, kind, sizes):
    """Five steps of the port's optimizer (the kernel) against torch's
    capturable multi-tensor update, each from the kernel's state."""
    ours_cls, torch_cls, kw = KINDS[kind]
    shapes = SIZES[sizes]()
    ps = _card_params(shapes, cuda, 0)
    qs = [p.clone() for p in ps]
    gen = torch.Generator(device=cuda).manual_seed(1)
    lr_a = torch.tensor(LR, device=cuda)
    lr_b = torch.tensor(LR, device=cuda)
    ours = ours_cls(ps, lr=lr_a, betas=BETAS, capturable=True, **kw)
    theirs = torch_cls(qs, lr=lr_b, betas=BETAS, capturable=True, foreach=True, **kw)
    theirs._warned_capturable_if_run_uncaptured = True
    before = (ok.adam_update.launches, ok.adam_update.elements)

    def grads(i):
        return [torch.randn(p.shape, generator=gen, device=cuda) for p in ps]

    _hold_steps(ours, theirs, ps, qs, grads, 4.0)
    torch.cuda.synchronize()
    assert ok.adam_update.launches - before[0] == 5
    assert ok.adam_update.elements - before[1] == 5 * sum(p.numel() for p in ps)


@pytest.mark.cuda
def test_kernel_equals_itself_the_plain_version_and_a_graph_replay(cuda):
    """The same state twice gives the same bits; the plain version on the
    card within 4 ulp; a CUDA graph of the call, replayed after the LR is
    filled in place, gives the eager call's bits at the new LR."""
    shapes = [(3,), (4097,), (129, 77)]

    def fresh():
        ps = _card_params(shapes, cuda, 4)
        gs = _card_params(shapes, cuda, 5)
        ms = [m * 0.2 for m in _card_params(shapes, cuda, 6)]
        vs = [v.square() for v in _card_params(shapes, cuda, 7)]
        steps = [torch.full((), 3.0, device=cuda) for _ in ps]
        return ps, gs, ms, vs, steps

    lr = torch.tensor(LR, device=cuda)
    a, b, plain = fresh(), fresh(), fresh()
    for st in (a, b):
        ok.adam_update(*st, lr=lr, betas=BETAS, eps=1e-8, weight_decay=WD)
    ok.adam_update_reference(*plain, lr=lr, betas=BETAS, eps=1e-8, weight_decay=WD)
    torch.cuda.synchronize()
    start = fresh()
    for x, y, z, s in zip(a, b, plain, start):
        for t, u, w, t0 in zip(x, y, z, s):
            assert torch.equal(t, u)
            if t.dim():
                assert _ulps(t, w, t0) <= 4.0
            else:
                assert float(t) == float(w) == 4.0
    graphed, eager = fresh(), fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        ok.adam_update(*graphed, lr=lr, betas=BETAS, eps=1e-8, weight_decay=WD)
    torch.cuda.current_stream().wait_stream(side)
    lr.fill_(3e-4)
    graph.replay()
    ok.adam_update(*eager, lr=lr, betas=BETAS, eps=1e-8, weight_decay=WD)
    torch.cuda.synchronize()
    for x, y in zip(graphed, eager):
        for t, u in zip(x, y):
            assert torch.equal(t, u)


@pytest.mark.cuda
def test_plan_is_the_launchers(cuda):
    import ctypes

    from vct_tpu_torch.ops._build import load_library

    lib = load_library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert lib.vct_adam_capacity() == 512
    for units in (0, 1, 1023, 1024, 1025, 10 ** 6, 433_440_032):
        blocks = ctypes.c_int(0)
        assert lib.vct_adam_plan(units, 0, ctypes.byref(blocks)) == 0
        assert blocks.value == ok.update_blocks(units, sms)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    def call(p, g=None, lr=None, step=None):
        g = torch.zeros_like(p) if g is None else g
        ok.adam_update([p], [g], [torch.zeros_like(p)], [torch.zeros_like(p)],
                       [torch.zeros((), device=cuda) if step is None else step],
                       lr=torch.tensor(LR, device=cuda) if lr is None else lr,
                       betas=BETAS, eps=1e-8)

    with pytest.raises(TypeError, match="dtype"):
        call(torch.zeros(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros((8, 16), device=cuda).t())
    with pytest.raises(ValueError, match="16-byte"):
        call(torch.zeros(65, device=cuda)[1:])
    with pytest.raises(ValueError, match="shape"):
        call(torch.zeros(64, device=cuda), g=torch.zeros(63, device=cuda))
    with pytest.raises(TypeError, match="lr"):
        call(torch.zeros(64, device=cuda), lr=LR)
    with pytest.raises(ValueError, match="is on"):
        call(torch.zeros(64, device=cuda), step=torch.zeros(()))
    ps = _card_params([(8,)], cuda, 0)
    for flag in ("amsgrad", "maximize"):
        with pytest.raises(ValueError, match=flag):
            po.Adam(ps, lr=torch.tensor(LR, device=cuda), capturable=True, **{flag: True})


@pytest.mark.cuda
def test_graphed_step_replays_one_update_over_every_trainable_element(cuda):
    """The graphed train step (Adam, AdamW): each replay adds one launch of
    the update and every trainable element to its counters, gives the eager
    step's bits, and a second run from the same start gives the same bits."""
    from tests.test_torch_port_cuda import (_hold_to_eager, _state_tensors, _train_batch,
                                            _train_state)
    from vct_tpu_torch.train.step import make_train_step

    for name in sorted(KINDS):
        runs = []
        for _ in range(2):
            eager_a, eager_b, graphed = (_train_state(cuda, name) for _ in range(3))
            trainable = sum(p.numel() for g in graphed.optimizer.param_groups
                            for p in g["params"])
            runner = make_train_step("caption")
            batches = [_train_batch(cuda, s) for s in range(2)]
            for i in range(4):
                batch = batches[i % 2]
                want = _state_tensors(eager_a, runner.eager(eager_a, batch)[1])
                again = _state_tensors(eager_b, runner.eager(eager_b, batch)[1])
                before = (ok.adam_update.launches, ok.adam_update.elements)
                _, metrics = runner(graphed, batch)
                torch.cuda.synchronize()
                got = _state_tensors(graphed, metrics)
                assert ok.adam_update.launches - before[0] == 1
                assert ok.adam_update.elements - before[1] == trainable
                _hold_to_eager(got, want, again)
            assert (runner.graphs, runner.replays) == (1, 3)
            runs.append(got)
        for k, v in runs[0].items():
            assert torch.equal(v, runs[1][k]), (name, k)
