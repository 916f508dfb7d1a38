"""The parallel layer of the port (``vct_tpu_torch.parallel``) against
``vct_tpu.parallel`` on the CPU: the mesh's sizing rules, ``tp_spec``,
``shard_batch``, then 2 and 4 gloo processes that train, validate and decode
on a mesh against the JAX step on the same mesh shape, and
``cli.train --cpu -ws 2``.

Both packages get one JAX init (``state_dict_from_jax``) and the same numpy
batch at a small size: 2 encoder and 2 decoder layers, E = 64, FF = 128,
vocab 102 (split at model 2, replicated at 4), float32, dropout 0; 8 rows,
the last two collate filler, captions of ragged lengths whose longest sits
in the first data rank's rows (so the RCE rectangle is the global batch's,
not each rank's). Bounds are those of ``tests/test_parallel.py``: after 3
Adam steps the losses at rtol 2e-5 and every parameter at atol 1e-3; eval
parts at rtol 2e-5; tokens equal.

The ranks are spawned (``parallel.mesh.spawn``, rendezvous through a file
under ``tmp_path``, one thread each); each spawned process imports this
module, so JAX is imported inside the test functions only.
"""

import json
import warnings

import numpy as np
import pytest
import torch

B, T, D_FEAT, E, H, FF, VOCAB, S, TEXT = 8, 5, 24, 64, 4, 128, 102, 12, 512
N_VALID = 6
STEPS = 3
MAX_LEN, START, END, BEAM = 8, 2, 3, 3
TASKS = ("caption", "match", "cross")
SPAWN_TIMEOUT = 240


def model_dict():
    return {
        "modal": ["m0"], "modal_shape": [D_FEAT], "embed_dim": E, "dropout": 0.0,
        "vocab_size": VOCAB, "activation": "gelu", "text_enc_type": "CLIP",
        "loss_beta": 0.3, "matching": {"enable_tem": True, "matching_loss": "CSL"},
        "video_encoder": {"layer": 2, "nhead": H, "feedforward": FF,
                          "mme": {"temporal": "encoding", "aggregation": "avg"}},
        "caption_decoder": {"layer": 2, "nhead": H, "feedforward": FF, "sce_loss_alpha": 0.5},
    }


def make_batch():
    """Collate-shaped: rows >= N_VALID copy row 0; row 1 holds the longest
    caption, rows 4-5 short ones."""
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((B, T, D_FEAT)).astype(np.float32)
    pad = np.zeros((B, T), bool)
    pad[2, -2:] = True
    ids = np.zeros((B, S), np.int32)
    for r, n in enumerate([3, S - 2, 6, 5, 2, 3, 0, 0]):
        ids[r, 0], ids[r, 1:n + 1], ids[r, n + 1] = START, rng.integers(5, VOCAB, n), END
    text = rng.standard_normal((B, TEXT)).astype(np.float32)
    feats[N_VALID:], pad[N_VALID:], ids[N_VALID:], text[N_VALID:] = \
        feats[0], pad[0], ids[0], text[0]
    return {"feats": [feats], "masks": [pad], "token_ids": ids, "token_mask": ids == 0,
            "text_feat": text, "row_valid": np.arange(B) < N_VALID}


def port_arrays(batch):
    return {k: [torch.tensor(a) for a in v] if isinstance(v, list) else torch.tensor(v)
            for k, v in batch.items()}


def port_model(state, tp=False):
    from vct_tpu_torch.config import ModelConfig, TPUConfig
    from vct_tpu_torch.convert import load_state_dict_into
    from vct_tpu_torch.models.mmt4caption import MMT4Caption

    model = MMT4Caption(ModelConfig.from_dict(model_dict()),
                        TPUConfig(dtype="float32", use_fused_loss=not tp))
    assert load_state_dict_into(model, state) == {"missing": [], "unexpected": []}
    return model


def train_state(task, state, mesh, tp, seed=0):
    from vct_tpu_torch.config import TrainConfig
    from vct_tpu_torch.parallel import mesh as pm
    from vct_tpu_torch.train.optimizers import build_optimizer
    from vct_tpu_torch.train.state import TrainState

    model = pm.shard_train_state(mesh, port_model(state, tp))
    opt = build_optimizer(TrainConfig.from_dict(
        {"task": task, "optimizer": {"name": "adam", "learning_rate": 1e-3}}), model)
    return TrainState(model, opt, torch.Generator().manual_seed(seed))


def port_run(task, state, batch, mesh=None, tp=False, ckpt=None):
    """3 Adam steps -> (per-step metrics, whole final weights, whole
    gradients of the first step); with ``ckpt`` the state is saved there."""
    from vct_tpu_torch.parallel import mesh as pm
    from vct_tpu_torch.train.state import save_checkpoint
    from vct_tpu_torch.train.step import make_train_step

    mesh = mesh or pm.Mesh()
    st = train_state(task, state, mesh, tp)
    model = st.model
    step = make_train_step(task, mesh if mesh.distributed else None)
    local = pm.shard_batch(mesh, port_arrays(batch))
    metrics, grads = [], None
    for _ in range(STEPS):
        st, m = step(st, local)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            split = model.tp_split
            grads = {k: (pm.gather_shards(p.grad, split[k], mesh) if k in split
                         else p.grad.clone())
                     for k, p in model.named_parameters() if p.grad is not None}
    if ckpt:
        save_checkpoint(ckpt, st, epoch=1, mesh=mesh)
    return metrics, pm.full_state_dict(mesh, model), grads


def port_decode(state, batch, mesh=None, tp=False):
    """Greedy and beam tokens of the whole batch (each data rank its rows)."""
    from vct_tpu_torch.decode import make_auto_beam_fn, make_auto_greedy_fn
    from vct_tpu_torch.parallel import mesh as pm

    model = pm.shard_train_state(mesh or pm.Mesh(), port_model(state, tp)).eval()
    arrays = port_arrays(batch)
    rows = mesh if mesh is not None and mesh.data > 1 else None
    greedy = make_auto_greedy_fn(model, MAX_LEN, START, END, mesh=rows)(
        arrays["feats"], arrays["masks"])[0]
    beam, scores = make_auto_beam_fn(model, MAX_LEN, START, END, BEAM, mesh=rows)(
        arrays["feats"], arrays["masks"])
    return greedy.long(), beam.long(), scores


def _rank(rank, world, shape, init, payload_path, out_path):
    """One spawned rank: train each task, take the eval parts, decode."""
    torch.set_num_threads(1)
    from vct_tpu_torch.parallel import mesh as pm
    from vct_tpu_torch.train.step import make_eval_step, reduce_eval_parts

    mesh = pm.make_mesh(*shape, device=torch.device("cpu"), backend="gloo", rank=rank,
                        world_size=world, init_method=init, timeout=SPAWN_TIMEOUT)
    payload = torch.load(payload_path, weights_only=False)
    state, batch, tp = payload["state"], payload["batch"], shape[1] > 1
    out = {"mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index)}
    for task in payload["tasks"]:
        ckpt = f"{out_path}.{task}.ckpt.pt"
        out[task] = port_run(task, state, batch, mesh, tp, ckpt)
        out[f"restored_{task}"] = restore_here(task, state, mesh, tp, ckpt)
        if payload["eval"]:
            model = port_model(state).eval()
            parts = make_eval_step(task, mesh)(model, pm.shard_batch(mesh, port_arrays(batch)))
            out[f"eval_{task}"] = reduce_eval_parts(parts, mesh)
    out["decode"] = port_decode(state, batch, mesh, tp)
    if rank == 0:
        torch.save(out, out_path)
    pm.destroy()


def restore_here(task, state, mesh, tp, ckpt):
    """The checkpoint restored on the mesh that wrote it -> (whole weights,
    whole optimizer state, re-seeded?, generator state)."""
    from vct_tpu_torch.parallel import mesh as pm
    from vct_tpu_torch.train.state import restore_checkpoint

    st = train_state(task, state, mesh, tp, seed=5)
    st, epoch, _ = restore_checkpoint(ckpt, st, mesh=mesh)
    assert epoch == 1
    return (pm.full_state_dict(mesh, st.model),
            pm.full_optimizer_state(mesh, st.model, st.optimizer), st.reseeded,
            st.generator.get_state())


def spawn_ranks(tmp_path, shape, tasks, eval_parts, state, batch):
    from vct_tpu_torch.parallel.mesh import spawn

    payload, out = tmp_path / "payload.pt", tmp_path / "out.pt"
    torch.save({"state": state, "batch": batch, "tasks": tasks, "eval": eval_parts}, payload)
    world = shape[0] * shape[1]
    spawn(_rank, world, args=(world, shape, f"file://{tmp_path}/rendezvous", str(payload),
                              str(out)), timeout=SPAWN_TIMEOUT)
    return dict(torch.load(out, weights_only=False), ckpt=f"{out}.{tasks[0]}.ckpt.pt")


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def jax_pieces(tp=False):
    import jax
    import jax.numpy as jnp

    from vct_tpu.config import ModelConfig, TPUConfig
    from vct_tpu.models.mmt4caption import MMT4Caption

    model = MMT4Caption(ModelConfig.from_dict(model_dict()),
                        TPUConfig(dtype="float32", use_fused_loss=not tp))
    b = make_batch()
    variables = model.init(jax.random.PRNGKey(3), [jnp.asarray(b["feats"][0])],
                           [jnp.asarray(b["masks"][0])], jnp.asarray(b["token_ids"]),
                           jnp.asarray(b["token_mask"]), jnp.asarray(b["text_feat"]),
                           method=MMT4Caption.cross_loss)
    return model, jax.tree_util.tree_map(np.array, variables)


def jax_batch(batch):
    import jax.numpy as jnp

    return {k: [jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in batch.items()}


def jax_run(task, shape, tp=False):
    """3 steps of the JAX step on make_mesh(*shape) (replicated, or the TP
    shardings) -> (per-step metrics, final weights in the port's keys)."""
    import jax

    from vct_tpu.config import TrainConfig
    from vct_tpu.parallel.mesh import make_mesh, replicate, shard_batch_arrays, \
        shard_train_state
    from vct_tpu.train.optimizers import build_optimizer
    from vct_tpu.train.state import make_train_state
    from vct_tpu.train.step import make_train_step
    from vct_tpu_torch.convert import state_dict_from_jax

    model, variables = jax_pieces(tp)
    opt = build_optimizer(TrainConfig.from_dict(
        {"task": task, "optimizer": {"name": "adam", "learning_rate": 1e-3}}),
        variables["params"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a sub-mesh of the 8 virtual devices
        mesh = make_mesh(*shape)
    state = make_train_state(variables, opt)
    state = shard_train_state(mesh, state) if tp else replicate(mesh, state)
    step = make_train_step(model, opt, task)
    batch = shard_batch_arrays(mesh, jax_batch(make_batch()))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    return metrics, state_dict_from_jax({"params": params, "buffers": variables["buffers"]})


@pytest.fixture(scope="module")
def weights():
    from vct_tpu_torch.convert import state_dict_from_jax

    _, variables = jax_pieces()
    return state_dict_from_jax(variables)


def assert_same_run(got, want):
    (m_got, p_got), (m_want, p_want) = got[:2], want[:2]
    assert len(m_got) == len(m_want) == STEPS
    for a, b in zip(m_got, m_want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, err_msg=k)
    assert set(p_got) == set(p_want)
    for k, v in p_want.items():
        np.testing.assert_allclose(p_got[k].numpy(), v.numpy(), atol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------
# sizing, tp_spec, shard_batch
# ---------------------------------------------------------------------------

SIZES = [(-1, 1, 8), (-1, 2, 8), (4, 2, 8), (2, 1, 8), (1, 1, 8), (8, 1, 8), (-1, 4, 8),
         (-1, 3, 8), (3, 3, 8), (16, 1, 8), (-1, 1, 1), (2, 1, 1)]


@pytest.mark.parametrize("data,model,n", SIZES)
def test_make_mesh_sizes_like_the_reference(data, model, n):
    import jax

    from vct_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vct_tpu_torch.parallel.mesh import mesh_shape

    def outcome(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                got = fn()
            except ValueError as e:
                return "error", str(e), []
        return "ok", got, [str(w.message) for w in caught]

    want = outcome(lambda: tuple(jax_make_mesh(data, model, jax.devices()[:n]).shape.values()))
    got = outcome(lambda: mesh_shape(data, model, n))
    assert got == want


def test_make_mesh_without_a_process_group_is_one_rank():
    from vct_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.distributed, mesh.is_main) == (1, 0, False, True)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        make_mesh(-1, 2)


@pytest.mark.parametrize("model_size", [2, 4])
def test_tp_spec_splits_what_the_reference_splits(model_size):
    """Every parameter of the JAX model: the port's split dim for its key is
    JAX's split axis, transposed where the converter transposes."""
    import jax

    from vct_tpu.parallel.mesh import _path_names
    from vct_tpu.parallel.mesh import tp_spec as jax_tp_spec
    from vct_tpu_torch.convert import jax_path_to_key
    from vct_tpu_torch.parallel.mesh import tp_spec

    _, variables = jax_pieces()
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        names = _path_names(path)
        spec = tuple(jax_tp_spec(names, leaf, model_size))
        key, transpose = jax_path_to_key(names)
        axis = spec.index("model") if "model" in spec else None
        if axis is not None and transpose and leaf.ndim == 2:
            axis = 1 - axis
        shape = leaf.T.shape if transpose and leaf.ndim == 2 else leaf.shape
        assert tp_spec(key, shape, model_size) == axis, key
        seen.add((key, axis))
    split = {k for k, a in seen if a is not None}
    assert any(k.endswith("linear1.weight") for k in split)
    assert ("cap_decoder.generator.weight" in split) == (VOCAB % model_size == 0)
    assert tp_spec("cap_decoder.generator.weight", (VOCAB, E), 1) is None


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (8, 1)])
def test_shard_batch_takes_the_reference_shards(shape):
    from vct_tpu.parallel.mesh import make_mesh, shard_batch_arrays
    from vct_tpu_torch.parallel.mesh import Mesh, shard_batch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmesh = make_mesh(*shape)
    b = make_batch()
    sharded = shard_batch_arrays(jmesh, {"ids": b["token_ids"], "feats": b["feats"]})
    devices = jmesh.devices
    for shard in sharded["ids"].addressable_shards:
        (d,), (m,) = np.nonzero(devices == shard.device)
        rank = d * shape[1] + m
        got = shard_batch(Mesh(*shape, rank=rank, world=shape[0] * shape[1]),
                          {"ids": torch.tensor(b["token_ids"]),
                           "feats": [torch.tensor(b["feats"][0])]})
        np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(shard.data))
        assert got["feats"][0].shape[0] == B // shape[0]
    with pytest.raises(ValueError, match="not divisible by the mesh's data size 3"):
        shard_batch(Mesh(3, 1), torch.zeros(8))


# ---------------------------------------------------------------------------
# 2 data ranks: caption, match and cross steps, eval parts, sharded decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_run(weights, tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("dp"), (2, 1), TASKS, True, weights,
                       make_batch())


@pytest.mark.parametrize("task", TASKS)
def test_data_parallel_step_matches_the_reference_mesh(dp_run, task):
    assert dp_run["mesh"] == (2, 1, 0, 0)
    assert_same_run(dp_run[task], jax_run(task, (2, 1)))


@pytest.mark.parametrize("task", TASKS)
def test_data_parallel_step_matches_one_process_on_the_joined_batch(dp_run, weights, task):
    assert_same_run(dp_run[task], port_run(task, weights, make_batch()))


@pytest.mark.parametrize("task", TASKS)
def test_data_parallel_gradients_are_the_joined_batch_gradients(dp_run, weights, task):
    """After DDP's mean over the ranks, each gradient of the first step is the
    one process's gradient on the joined batch (to 1e-5 of its largest
    value): a gradient off by a factor, which Adam's update would hide, shows
    here."""
    got, want = dp_run[task][2], port_run(task, weights, make_batch())[2]
    assert set(got) >= set(want)
    for k, g in want.items():
        scale = float(g.abs().max())
        assert float((got[k] - g).abs().max()) <= 1e-5 * scale + 1e-12, k


def test_per_rank_means_would_differ(weights):
    """The ranks' token counts differ, so the mean of the per-rank caption
    losses is not the global loss the step reports: the global counts are
    what the test above holds."""
    from vct_tpu_torch.parallel.mesh import Mesh, shard_batch

    model = port_model(weights).eval()
    arrays = port_arrays(make_batch())
    whole = float(model.caption_loss(arrays["feats"], arrays["masks"], arrays["token_ids"],
                                     arrays["token_mask"], row_valid=arrays["row_valid"]))
    means = []
    for rank in range(2):
        a = shard_batch(Mesh(2, 1, rank=rank, world=2), arrays)
        means.append(float(model.caption_loss(a["feats"], a["masks"], a["token_ids"],
                                              a["token_mask"], row_valid=a["row_valid"])))
    assert abs(np.mean(means) - whole) > 1e-3 * abs(whole)


@pytest.mark.parametrize("task", TASKS)
def test_eval_parts_on_the_padded_batch_equal_the_unpadded_sub_batch(dp_run, task):
    import jax.numpy as jnp

    from vct_tpu.train.step import make_eval_step

    model, variables = jax_pieces()
    sub = {k: ([jnp.asarray(a[:N_VALID]) for a in v] if isinstance(v, list)
               else jnp.asarray(v[:N_VALID]))
           for k, v in make_batch().items() if k != "row_valid"}
    want = {k: float(v) for k, v in make_eval_step(model, task)(variables, sub).items()}
    got = dp_run[f"eval_{task}"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)


def through_end(tokens):
    """The tokens a caption reads: after a row's end token they depend on
    when the other rows of its launch end, so they are not compared."""
    from vct_tpu_torch.decode import through_end as cut

    return cut(torch.as_tensor(np.asarray(tokens)), END).numpy()


def test_sharded_decode_gives_the_one_process_tokens(dp_run, weights):
    greedy, beam, scores = port_decode(weights, make_batch())
    got_greedy, got_beam, got_scores = dp_run["decode"]
    np.testing.assert_array_equal(through_end(got_greedy), through_end(greedy))
    np.testing.assert_array_equal(through_end(got_beam), through_end(beam))
    np.testing.assert_allclose(got_scores.numpy(), scores.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# tensor parallelism: model 2 (2 ranks) and data 2 x model 2 (4 ranks)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_runs(weights, tmp_path_factory):
    return {shape: spawn_ranks(tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}"), shape,
                               ("caption",), False, weights, make_batch())
            for shape in ((1, 2), (2, 2))}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tensor_parallel_step_matches_the_reference_tp_mesh(tp_runs, shape):
    assert tp_runs[shape]["mesh"] == shape + (0, 0)
    assert_same_run(tp_runs[shape]["caption"], jax_run("caption", shape, tp=True))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_checkpoints_hold_whole_tensors_and_load_at_any_world_size(tp_runs, tmp_path_factory,
                                                                   weights, shape):
    """Written by rank 0 from the shards: whole weights and Adam moments, no
    DDP prefix, every rank's generator. Restored on the mesh that wrote it,
    each rank gets its shards and its generator back; restored in one
    process, the whole weights, with the generator flagged for re-seeding."""
    from vct_tpu_torch.parallel.mesh import Mesh, full_optimizer_state
    from vct_tpu_torch.train.state import restore_checkpoint

    ckpt = tp_runs[shape]["ckpt"]
    payload = torch.load(ckpt, weights_only=True)
    final = tp_runs[shape]["caption"][1]
    assert set(payload["model"]) == set(final) == set(weights)
    for k, v in final.items():
        assert torch.equal(payload["model"][k], v), k
        assert payload["model"][k].shape == weights[k].shape
    world = shape[0] * shape[1]
    assert len(payload["generators"]) == world
    moments = [m for m in payload["optimizer"]["state"].values()]
    shapes = {tuple(v.shape) for v in weights.values()}
    assert moments and all(tuple(m["exp_avg"].shape) in shapes for m in moments)
    got, opt, reseeded, gen = tp_runs[shape]["restored_caption"]
    assert not reseeded and torch.equal(gen, payload["generators"][0])
    for k, v in final.items():
        assert torch.equal(got[k], v), k
    assert opt["state"].keys() == payload["optimizer"]["state"].keys()
    for i, m in payload["optimizer"]["state"].items():
        assert torch.equal(opt["state"][i]["exp_avg_sq"], m["exp_avg_sq"]), i
    one = train_state("caption", weights, Mesh(), tp=False, seed=5)
    one, epoch, _ = restore_checkpoint(ckpt, one)
    assert epoch == 1 and one.reseeded
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, final[k]), k
    for i, m in full_optimizer_state(Mesh(), one.model, one.optimizer)["state"].items():
        assert torch.equal(m["exp_avg"], payload["optimizer"]["state"][i]["exp_avg"]), i


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tensor_parallel_decode_gives_the_reference_tokens(tp_runs, shape):
    """Greedy and beam search with the vocab-split head and the split FFNs
    give the tokens of the whole weights on one JAX device
    (``test_tp_mesh_beam_decode_matches_single_device``)."""
    import jax.numpy as jnp

    from vct_tpu.decode import greedy_generate, make_beam_fn

    model, variables = jax_pieces()
    b = make_batch()
    feats, masks = [jnp.asarray(b["feats"][0])], [jnp.asarray(b["masks"][0])]
    want_greedy, _ = greedy_generate(model, variables, feats, masks, max_len=MAX_LEN,
                                     start_id=START, end_id=END)
    want_beam, want_scores = make_beam_fn(model, MAX_LEN, START, END, BEAM)(
        variables, feats, masks)
    greedy, beam, scores = tp_runs[shape]["decode"]
    np.testing.assert_array_equal(through_end(greedy), through_end(want_greedy))
    np.testing.assert_array_equal(through_end(beam), through_end(want_beam))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=2e-5)


@pytest.mark.parametrize("shards", [2, 3])
def test_vocab_merges_break_ties_by_the_lowest_index(shards):
    """The merges of per-shard (max, argmax) and top-k give the whole vocab's
    first-win argmax and ``topk_first_win`` on ties planted within and
    across shards."""
    from vct_tpu_torch.decode import merge_argmax, merge_topk
    from vct_tpu_torch.ops.decode_kernels import topk_first_win

    rng = np.random.default_rng(shards)
    v, k = 12, 4
    whole = torch.tensor(rng.integers(0, 4, (5, v)).astype(np.float32))  # many ties
    whole[0] = 3.0  # every column ties
    per = v // shards
    parts = [whole[:, i * per:(i + 1) * per] for i in range(shards)]
    vals = torch.stack([p.max(dim=-1).values for p in parts])
    idxs = torch.stack([torch.argmax(p, dim=-1) + i * per for i, p in enumerate(parts)])
    assert merge_argmax(vals, idxs).tolist() == torch.argmax(whole, dim=-1).tolist()
    tops = [topk_first_win(p, k) for p in parts]
    got_v, got_i = merge_topk(torch.cat([t[0] for t in tops], dim=1),
                              torch.cat([t[1] + i * per for i, t in enumerate(tops)], dim=1), k)
    want_v, want_i = topk_first_win(whole, k)
    assert got_i.tolist() == want_i.tolist() and torch.equal(got_v, want_v)


# ---------------------------------------------------------------------------
# the training CLI at -ws 2 on the host
# ---------------------------------------------------------------------------

N_VID, WT, WE = 8, 5, 16
WORDS = ["a", "person", "does", "action", "variant"] + [str(i) for i in range(8)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_parallel_ws")
    (root / "feats").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(N_VID):
        np.save(root / "feats" / f"vid{i}.npy", rng.standard_normal((WT, WE)).astype(np.float32))
        lines += [f"vid{i} a person does action {i} variant {j}" for j in range(3)]
    (root / "ann.txt").write_text("\n".join(lines))
    (root / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS))
    return root


def cli_config(root, epochs, tag):
    split = {"feat_dir": [str(root / "feats")], "annotation_path": str(root / "ann.txt"),
             "dataset": "msvd", "mode": "by_caption", "split_mode": "train", "batch_size": 4}
    return {
        "data": {"train": split, "validation": dict(split, split_mode="validate"),
                 "eval": dict(split, mode="by_video", split_mode="validate", batch_size=4)},
        "train": {"task": "caption",
                  "optimizer": {"name": "adam", "learning_rate": 1e-3},
                  "earlystop": 5, "epoch": epochs, "save_frequency": 100,
                  "save_dir": str(root / "ckpt"), "log_dir": str(root / "log"), "tag": tag,
                  "metric_earlystop": True},
        "test": {"max_length": 10},
        "model": {"modal": ["CLIP4Clip"], "modal_shape": [WE], "tokenizer": "bert-base-uncased",
                  "text_enc_type": "CLIP", "embed_dim": 32, "dropout": 0.1, "activation": "gelu",
                  "video_encoder": {"layer": 1, "nhead": 2, "feedforward": 64,
                                    "mme": {"temporal": "encoding", "aggregation": "avg"}},
                  "caption_decoder": {"layer": 1, "nhead": 2, "feedforward": 64}},
        "tpu": {"max_frames": WT, "max_caption_len": 12, "dtype": "float32",
                "vocab_path": str(root / "vocab.txt"), "progress_bar": False},
    }


def _cli_rank(rank, args, world, init_method, out):
    """``cli.train``'s spawned rank (``_rank_main``), which also writes what
    the rank ends with beside the config."""
    import os

    from vct_tpu_torch.cli import train as cli

    trainer, scores = cli._rank_main(rank, args, world, init_method, out)
    record = {"rank": rank, "world": trainer.mesh.world, "backend": trainer.mesh.backend,
              "scores": scores, "epochs": trainer.history,
              "captions": trainer.last_captions}
    with open(os.path.join(os.path.dirname(args.config), f"report_{rank}.json"), "w") as f:
        json.dump(record, f)


@pytest.fixture(scope="module")
def cli_run(workspace):
    from vct_tpu_torch.cli import train as cli

    path = workspace / "cfg.json"
    path.write_text(json.dumps(cli_config(workspace, 1, "ddp")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "_rank_main", _cli_rank)
        scores = cli.main(["-c", str(path), "--cpu", "-ws", "2", "--no_tensorboard"])
    return path, scores, [json.loads((workspace / f"report_{r}.json").read_text())
                          for r in range(2)]


def test_cli_ws2_ranks_agree(cli_run):
    _, scores, reports = cli_run
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in reports)
    assert reports[0]["scores"] == reports[1]["scores"] == scores
    assert {"Bleu_4", "CIDEr"} <= set(scores)
    assert reports[0]["epochs"] == reports[1]["epochs"]
    assert reports[0]["captions"] == reports[1]["captions"]
    assert len(reports[0]["epochs"][0]["step_losses"]) == 24 // 4  # 24 captions, batch 4


def test_cli_ws2_writes_whole_checkpoints_from_rank_0(cli_run, workspace):
    files = sorted(p.name for p in (workspace / "ckpt").iterdir())
    assert files == ["ddp_earlystop.pt", "ddp_latest.pt"]  # no half-written copies
    payload = torch.load(workspace / "ckpt" / "ddp_latest.pt", weights_only=True)
    assert not any(k.startswith("module.") for k in payload["model"])
    assert len(payload["generators"]) == 2
    assert not torch.equal(payload["generators"][0], payload["generators"][1])


def test_cli_ws2_decode_split_gives_the_one_process_captions(cli_run):
    """One process with the checkpoint's weights decodes the eval split to
    the captions the two ranks decoded, caption for caption (not all empty),
    and to their scores, and resumes the run at -ws 1."""
    from vct_tpu_torch.cli import train as cli
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.train.loop import Trainer

    path, scores, reports = cli_run
    cfg = Config.from_dict(json.loads(path.read_text()))
    logs = []
    tr = Trainer(cfg, device=torch.device("cpu"), log=logs.append)
    tr.resume(str(cfg.train.save_dir + "/ddp_latest.pt"))
    assert tr.start_epoch == 1 and tr.eval_epoch() == scores
    assert tr.last_captions == reports[0]["captions"]
    assert len(tr.last_captions) == N_VID and any(tr.last_captions.values())
    assert any("re-seeded" in line for line in logs)
    cfg2 = json.loads(path.read_text())
    cfg2["train"]["epoch"] = 2
    path.write_text(json.dumps(cfg2))
    again = cli.main(["-c", str(path), "--cpu", "-ws", "1", "--no_tensorboard",
                      "--resume", "auto"])
    assert {"Bleu_4", "CIDEr"} <= set(again)
