"""The port's compiled train and validation steps and the module path's
decode programs on the CPU, against the reference's ``jax.jit`` factories:
``train.step.make_train_step`` / ``make_eval_step`` against
``vct_tpu.train.step``'s, and ``decode.make_greedy_fn`` / ``make_beam_fn``
against ``vct_tpu.decode``'s; then the staged module path against the eager
one bit for bit, and the step runners' bookkeeping.

On the CPU no CUDA graph is built: the step factories run the eager step,
and the staged decode runs its stage functions directly. The runners'
capture and replay logic is driven here through a stand-in for
``graphs.capture`` whose replay re-runs the captured function, which is
what a replay of a CUDA graph computes. Card tests:
``test_torch_port_cuda.py``; every tensor op the card captures runs here.

Tolerances, as in the files whose models these reuse: train losses 1e-4
relative (``test_torch_port_train.py``, whose parameter bounds apply too);
eval parts 1e-4 relative with the counts exact (``test_torch_port_matching.py``);
greedy tokens equal and the attention maps within 1e-5; beam tokens equal
and scores within 1e-4 (``test_torch_port_beam.py``); the staged module
path against the eager one bit for bit.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vct_tpu.decode import make_beam_fn as jax_make_beam_fn
from vct_tpu.decode import make_greedy_fn as jax_make_greedy_fn
from vct_tpu_torch import graphs
from vct_tpu_torch.convert import state_dict_from_jax
from vct_tpu_torch.decode import beam_generate, greedy_generate, make_beam_fn, make_greedy_fn
from vct_tpu_torch.train import step as pstep

from tests import test_torch_port_matching as tm
from tests import test_torch_port_train as tt

MAX_LEN = 10


# ---------------------------------------------------------------------------
# the train and validation steps against the reference's jitted steps
# ---------------------------------------------------------------------------


def _step_batches(seed):
    feats, pad, ids, idpad, valid = tt.make_batch(seed=seed)
    jbatch = {"feats": [jnp.asarray(feats)], "masks": [jnp.asarray(pad)],
              "token_ids": jnp.asarray(ids), "token_mask": jnp.asarray(idpad),
              "row_valid": jnp.asarray(valid)}
    pbatch = {"feats": [torch.tensor(feats)], "masks": [torch.tensor(pad)],
              "token_ids": torch.tensor(ids), "token_mask": torch.tensor(idpad),
              "row_valid": torch.tensor(valid)}
    return jbatch, pbatch


@pytest.mark.parametrize("name,kw", [("adam", {}), ("adamw", {"weight_decay": 0.01}),
                                     ("sgd", {"momentum": 0.9})])
def test_step_factory_matches_the_reference_jit(name, kw):
    """Three steps of ``make_train_step``'s runner (on the host: the eager
    step, set up for the host by ``settle_optimizer``) against the
    reference's ``jax.jit`` with donated state, two batches in turn."""
    from vct_tpu.config import TrainConfig as JTrainConfig
    from vct_tpu.train.optimizers import build_optimizer as j_build
    from vct_tpu.train.state import make_train_state as j_state
    from vct_tpu.train.step import make_train_step as j_step
    from vct_tpu_torch.config import TrainConfig
    from vct_tpu_torch.train.optimizers import build_optimizer
    from vct_tpu_torch.train.state import make_train_state

    lr = 1e-3
    jm, variables, pm = tt.build_pair()
    batches = [_step_batches(4), _step_batches(5)]
    jopt = j_build(JTrainConfig.from_dict(tt._train_config(name, lr, **kw)), variables["params"])
    jstate = j_state(jax.tree_util.tree_map(jnp.asarray, variables), jopt)
    jstep = j_step(jm, jopt, "caption")
    popt = build_optimizer(TrainConfig.from_dict(tt._train_config(name, lr, **kw)), pm)
    for group in popt.param_groups:  # the host's update: float LR, no card flags
        assert isinstance(group["lr"], float) and not group.get("capturable")
        assert not group.get("fused")
    pstate = make_train_state(pm, popt, device=torch.device("cpu"), seed=0)
    step = pstep.make_train_step("caption")
    assert isinstance(step, pstep.GraphedTrainStep)
    for i in range(3):
        jbatch, pbatch = batches[i % 2]
        jstate, jmetrics = jstep(jstate, jbatch)
        pstate, pmetrics = step(pstate, pbatch)
        np.testing.assert_allclose(float(pmetrics["loss"]), float(jmetrics["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert pstate.step == 3 == int(jstate.step)
    assert (step.sets, step.graphs, step.replays) == (1, 0, 0)  # one set, no graph on the host
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    atol = 2e-5 if name == "sgd" else 2 * lr
    for key, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=atol, rtol=0,
                                   err_msg=key)
        assert float((p.detach() - want[key]).abs().mean()) < 2e-5, key


@pytest.mark.parametrize("task", ["caption", "match", "cross"])
def test_eval_step_parts_match_the_reference_jit(task):
    from vct_tpu.train.step import make_eval_step as j_eval

    jm, variables, pm = tm.build_pair(tm.MATCHINGS[2])  # a fixed temperature
    feats, pad, ids, idpad, text, valid = tm.make_batch(seed=2)
    jbatch = {"feats": [jnp.asarray(feats)], "masks": [jnp.asarray(pad)],
              "row_valid": jnp.asarray(valid)}
    pbatch = {"feats": [torch.tensor(feats)], "masks": [torch.tensor(pad)],
              "row_valid": torch.tensor(valid)}
    if task != "match":
        jbatch.update(token_ids=jnp.asarray(ids), token_mask=jnp.asarray(idpad))
        pbatch.update(token_ids=torch.tensor(ids), token_mask=torch.tensor(idpad))
    if task != "caption":
        jbatch["text_feat"], pbatch["text_feat"] = jnp.asarray(text), torch.tensor(text)
    want = {k: float(v) for k, v in j_eval(jm, task)(variables, jbatch).items()}
    step = pstep.make_eval_step(task)
    assert isinstance(step, pstep.GraphedEvalStep)
    got = {k: float(v) for k, v in step(pm, pbatch).items()}
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_n"):
            assert got[k] == want[k], k  # the counts are exact
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the module path's decode programs against the reference's jitted ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """The narrow matching model (two decoder layers, vocab 50)."""
    return tm.build_pair(tm.MATCHINGS[0])


def _inputs(b, seed=0, t=tm.T):
    """Features [b, t, D_FEAT] and pad masks (every third row ends in 2 pads)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, tm.D_FEAT)).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[1::3, -2:] = True
    return [feats], [pad]


def _torch(arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("collect_attn", [False, True])
def test_make_greedy_fn_matches_the_reference(pair, collect_attn):
    """Row 0's fourth token as the end token, so row 0 ends early and the
    other rows run on."""
    jm, variables, pm = pair
    feats, masks = _inputs(5, seed=1)
    free, _ = greedy_generate(pm, _torch(feats), _torch(masks), max_len=MAX_LEN, start_id=2,
                              end_id=-1)
    end_id = int(free[0, 3])
    want_t, want_a = jax_make_greedy_fn(jm, MAX_LEN, 2, end_id, collect_attn=collect_attn)(
        variables, [jnp.asarray(a) for a in feats], [jnp.asarray(a) for a in masks])
    fn = make_greedy_fn(pm, MAX_LEN, 2, end_id, collect_attn=collect_attn)
    got_t, got_a = fn(_torch(feats), _torch(masks))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert (got_t[0] == end_id).any() and fn.sets == 1
    if collect_attn:
        assert got_a.shape == np.asarray(want_a).shape
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-5, rtol=0)
    else:
        assert got_a is None and want_a is None


def test_make_beam_fn_matches_the_reference(pair):
    jm, variables, pm = pair
    feats, masks = _inputs(3, seed=2)
    want_t, want_s = jax_make_beam_fn(jm, MAX_LEN, 2, 7, 3)(
        variables, [jnp.asarray(a) for a in feats], [jnp.asarray(a) for a in masks])
    fn = make_beam_fn(pm, MAX_LEN, 2, 7, 3)
    got_t, got_s = fn(_torch(feats), _torch(masks))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=1e-4)
    assert fn.sets == 1


def test_staged_module_path_is_the_eager_one_bit_for_bit(pair):
    """Greedy with attention maps, rows ending early (row 0's third token as
    the end token ends row 0 in the first stage, the rest run on), and the
    beam; two calls each, one set."""
    _, _, pm = pair
    feats, masks = _torch(_inputs(6, seed=3)[0]), _torch(_inputs(6, seed=3)[1])
    free, _ = greedy_generate(pm, feats, masks, max_len=20, start_id=2, end_id=-1)
    for end_id in (-1, int(free[0, 2])):
        want_t, want_a = greedy_generate(pm, feats, masks, max_len=20, start_id=2,
                                         end_id=end_id, collect_attn=True)
        fn = make_greedy_fn(pm, 20, 2, end_id, collect_attn=True)
        for _ in range(2):
            got_t, got_a = fn(feats, masks)
            torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)
            torch.testing.assert_close(got_a, want_a, rtol=0, atol=0)
        assert fn.sets == 1
    want = beam_generate(pm, feats, masks, beam_size=2, max_len=20, start_id=2,
                         end_id=int(free[0, 2]))
    fn = make_beam_fn(pm, 20, 2, int(free[0, 2]), 2)
    for _ in range(2):
        for got, w in zip(fn(feats, masks), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_auto_dispatch_stages_the_module_path(pair, monkeypatch):
    """``make_auto_beam_fn`` with ``tpu.use_pallas_attention`` false (and
    ``make_auto_greedy_fn`` with attention maps) take the staged module path
    and name its runner; their results are the eager module path's."""
    import dataclasses

    from vct_tpu_torch.decode import make_auto_beam_fn, make_auto_greedy_fn

    _, _, pm = pair
    monkeypatch.setattr(pm, "tpu", dataclasses.replace(pm.tpu, use_pallas_attention=False))
    feats, masks = (_torch(a) for a in _inputs(3, seed=6))
    beam = make_auto_beam_fn(pm, MAX_LEN, 2, 7, 2)
    greedy = make_auto_greedy_fn(pm, MAX_LEN, 2, 7, collect_attn=True)
    for fn, want in ((beam, beam_generate(pm, feats, masks, beam_size=2, max_len=MAX_LEN,
                                          start_id=2, end_id=7)),
                     (greedy, greedy_generate(pm, feats, masks, max_len=MAX_LEN, start_id=2,
                                              end_id=7, collect_attn=True))):
        for got, w in zip(fn(feats, masks), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
        assert fn.runner.sets == 1


def test_module_path_one_set_per_shape_and_results_its_own(pair):
    _, _, pm = pair
    fn = make_greedy_fn(pm, MAX_LEN, 2, -1, collect_attn=True)
    for (b, t, seed), sets in zip([(4, tm.T, 0), (4, tm.T, 1), (2, tm.T, 2), (4, tm.T + 2, 3)],
                                  [1, 1, 2, 3]):
        fn(*[_torch(a) for a in _inputs(b, seed, t)])
        assert fn.sets == sets
    first_t, first_a = fn(*[_torch(a) for a in _inputs(4, seed=4)])
    kept_t, kept_a = first_t.clone(), first_a.clone()
    second_t, second_a = fn(*[_torch(a) for a in _inputs(4, seed=5)])
    torch.testing.assert_close(first_t, kept_t, rtol=0, atol=0)
    torch.testing.assert_close(first_a, kept_a, rtol=0, atol=0)
    assert not torch.equal(first_a, second_a)
    gs = fn._sets[graphs.shape_key({"feats": _torch(_inputs(4)[0]),
                                    "masks": _torch(_inputs(4)[1])})]
    state = {t.untyped_storage().data_ptr() for t in gs.st.values()
             if isinstance(t, torch.Tensor)}
    assert not {second_t.untyped_storage().data_ptr(),
                second_a.untyped_storage().data_ptr()} & state


# ---------------------------------------------------------------------------
# the step runners' capture, replay and drop, through a stand-in capture
# ---------------------------------------------------------------------------


class _Replayed:
    """What a CUDA graph's replay computes: the captured function run again
    on the static inputs, its outputs written into the captured ones."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.clear()
        self.out.update(self.fn())


@pytest.fixture
def host_graphs(monkeypatch):
    """The runners' card route on the host: a capture records its function
    (and runs nothing), a replay runs it."""
    captured = []

    def capture(fn, *, pool, generators=()):
        out = {}
        captured.append(list(generators))
        return _Replayed(fn, out), out

    @contextlib.contextmanager
    def growth(device, into):
        into["bytes"] = 0
        yield

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "side_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "pool_growth", growth)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graphs, "on_card", lambda inputs: True)
    return captured


def _train_pair(name="adam"):
    """Two train states with the same weights and dropout seed (dropout 0.1,
    so the generator is drawn from)."""
    from vct_tpu_torch.config import TrainConfig
    from vct_tpu_torch.train.optimizers import build_optimizer
    from vct_tpu_torch.train.state import make_train_state

    states = []
    for _ in range(2):
        _, _, pm = tt.build_pair(dropout=0.1)
        opt = build_optimizer(TrainConfig.from_dict(tt._train_config(name, 1e-3)), pm)
        states.append(make_train_state(pm, opt, device=torch.device("cpu"), seed=7))
    return states


def _assert_same_state(a, b):
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step


def test_train_runner_replays_the_eager_step(host_graphs, tmp_path):
    """A shape's first call is the eager step; later calls copy the batch in
    and replay, bit for bit the eager steps (losses, parameters, generator,
    step counter) across a learning rate change; the metrics are the
    caller's own; the generator is registered with the capture; one set per
    batch shape (``text_feat`` is part of the key); a restore drops the
    graphs."""
    from vct_tpu_torch.train.optimizers import set_learning_rate
    from vct_tpu_torch.train.state import restore_checkpoint, save_checkpoint

    eager_state, graphed_state = _train_pair()
    eager = pstep.make_train_step("caption").eager
    runner = pstep.make_train_step("caption")
    batches = [_step_batches(s)[1] for s in (4, 5, 6)]
    held = []
    for i, batch in enumerate(batches):
        if i == 2:
            set_learning_rate(eager_state.optimizer, 3e-4)
            set_learning_rate(graphed_state.optimizer, 3e-4)
        _, want = eager(eager_state, batch)
        _, got = runner(graphed_state, batch)
        held.append(got)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        _assert_same_state(eager_state, graphed_state)
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 2)
    assert host_graphs == [[graphed_state.generator]]
    assert len({id(m["loss"]) for m in held}) == 3
    assert len({m["loss"].untyped_storage().data_ptr() for m in held}) == 3

    with_text = dict(batches[0], text_feat=torch.zeros((tt.B, 512)))
    assert graphs.shape_key(with_text) != graphs.shape_key(batches[0])
    ckpt = str(tmp_path / "state.pt")
    save_checkpoint(ckpt, graphed_state)
    restore_checkpoint(ckpt, graphed_state)
    runner(graphed_state, batches[0])  # captured again, first eagerly
    assert (runner.sets, runner.graphs, runner.replays) == (2, 2, 2)
    assert len(runner._sets) == 1
    eager(eager_state, batches[0])
    _assert_same_state(eager_state, graphed_state)


def test_eval_runner_replays_and_drops_for_another_model(host_graphs):
    _, _, pm = tm.build_pair(tm.MATCHINGS[0])
    _, _, other = tm.build_pair(tm.MATCHINGS[1])
    feats, pad, ids, idpad, text, valid = tm.make_batch(seed=3)
    batch = {"feats": [torch.tensor(feats)], "masks": [torch.tensor(pad)],
             "row_valid": torch.tensor(valid), "token_ids": torch.tensor(ids),
             "token_mask": torch.tensor(idpad), "text_feat": torch.tensor(text)}
    runner = pstep.make_eval_step("cross")
    want = runner.eager(pm, batch)
    first, again = runner(pm, batch), runner(pm, batch)
    for got in (first, again):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert (runner.sets, runner.graphs, runner.replays) == (1, 1, 1)
    assert first["ce_sum"].untyped_storage().data_ptr() != \
        again["ce_sum"].untyped_storage().data_ptr()
    runner(other, batch)
    assert (runner.sets, runner.graphs, len(runner._sets)) == (2, 2, 1)


def test_steps_stay_eager_on_a_process_group():
    """A mesh with a process group (DDP, tensor parallelism) gets the eager
    steps, which a CUDA graph does not capture."""
    from vct_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(backend="gloo")
    for factory in (pstep.make_train_step, pstep.make_eval_step):
        assert not isinstance(factory("caption", mesh), graphs.Staged)
        assert isinstance(factory("caption", Mesh()), graphs.Staged)


def test_fixed_temperature_is_made_once_per_device(monkeypatch):
    """The match loss with a fixed temperature builds no tensor from host
    values after its first call (a copy from the host, which a capture
    refuses)."""
    from vct_tpu_torch.models.matching import ContrastiveLoss

    loss = ContrastiveLoss("CSL", enable_tem=False, fixed_tem=0.2)
    video, text = (torch.tensor(a) for a in tm._feats(0))
    first = loss(video, text)

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host values")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    torch.testing.assert_close(loss(video, text), first, rtol=0, atol=0)
    assert len(loss._fixed) == 1
    monkeypatch.undo()
    want = tm.pl.clip_symmetric_loss(video, text, torch.tensor([0.2]))
    torch.testing.assert_close(first, want, rtol=0, atol=0)


def test_capture_keeps_the_garbage_collector_off_while_it_captures(monkeypatch):
    """``graphs.capture`` keeps the garbage collector off from the capture's
    start to its end, so a collection cannot destroy an older graph inside a
    capture (which the card refuses); the collector is on again after, also
    when the captured function raises."""
    import gc

    seen = []

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

        def capture_begin(self, **kw):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    assert gc.isenabled()
    _, out = graphs.capture(lambda: seen.append(("fn", gc.isenabled())) or 7, pool=None)
    assert out == 7 and seen == [("begin", False), ("fn", False), ("end", False)]
    assert gc.isenabled()

    def boom():
        raise ValueError("inside the capture")

    with pytest.raises(ValueError):
        graphs.capture(boom, pool=None)
    assert gc.isenabled()
