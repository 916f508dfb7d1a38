"""Training: ``Trainer.train_epoch`` as ``cli.train`` builds the Trainer.

Set-up writes the train split (seeded features and captions, MSVD format)
and a synthetic vocabulary, builds the Trainer, loads the seed's float32
master weights through the port's loader, has the Trainer's train loader
build the first batches of its epoch (``Feed``), and drives the same object
through its first three steps, each through ``train_epoch`` and that feed:
the first runs eagerly and captures the step's graph, the next two replay
it. Those steps are what the reference follows. The window then runs epochs
on the same object and feed until ``seconds`` have passed; the last epoch
ends on its loss fetch (a device sync). The loader's thread is bypassed in
the window: it builds a batch at the host's pace, which drifts between runs
by more than a step. Validation and the epoch's eval decode are off, as in
the window of a ``fit`` epoch they come after.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

from benchlib import data, trace
from benchlib.context import Context, Outcome, release
from benchlib.hoststats import HostWatch, percentile, segments

SPLIT = 0  # the train split's number in ``benchlib.data``
CHECKED_STEPS = 3


class Feed:
    """The Trainer's train loader as the window sees it. In set-up the
    loader itself builds the first ``ring`` batches of its epoch 0 (the
    program's own rows, collation and tokens), which stay on the host; the
    feed hands them out in turn, ``len(loader)`` to an epoch as the loader
    would, so that the step and not the loader's thread sets the pace. It
    keeps the benchmark's span around each fetch, its time (``fetched_at``),
    a count of the batches handed out, each batch's (video, caption) rows
    while ``limit`` is set, and an end: no batch after ``limit`` batches or
    after the deadline."""

    def __init__(self, loader, ring: int, spans: trace.Spans, recorder=None):
        self.loader, self.spans, self.recorder = loader, spans, recorder
        loader.set_epoch(0)
        it = iter(loader)
        self.batches = [b for _, b in zip(range(ring), it)]
        it.close()  # stops the loader's thread
        if not self.batches:
            raise RuntimeError("the train loader gave no batch")
        self.next = 0
        self.limit = None
        self.deadline = None
        self.served = 0
        self.fetched_at: List[float] = []
        self.rows: List[List] = []

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        for handed in range(len(self.loader)):
            if self.recorder is not None:
                self.recorder.poll()
            if self.limit is not None and handed >= self.limit:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            self.fetched_at.append(time.perf_counter())
            with self.spans("bench.loader.next"):
                batch = self.batches[self.next % len(self.batches)]
                self.next += 1
            if self.limit is not None:
                self.rows.append(list(zip(batch.vids, batch.captions)))
            self.served += 1
            yield batch


def spanned(fn, spans: trace.Spans, name: str):
    def call(*a, **k):
        with spans(name):
            return fn(*a, **k)

    return call


def first_gradients(trainer) -> Dict[str, "torch.Tensor"]:
    """By logical leaf, the first gradient as Adam holds it after one step
    (``exp_avg / (1 - beta1)``), copied to the host until it is judged."""
    from reference.checks import logical_grads

    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    state = trainer.optimizer.state
    return logical_grads((name, (state[p]["exp_avg"] / (1 - beta1)).cpu())
                         for name, p in trainer.model.named_parameters()
                         if "exp_avg" in state.get(p, {}))


def run(ctx: Context) -> Outcome:
    import torch

    from benchlib.weights import make_weights

    t = ctx.traffic
    vocab_path = os.path.join(ctx.tmp, "vocab.txt")
    data.write_vocab(vocab_path, ctx.dims["vocab"])
    feat_dir, ann, index = data.write_split(
        ctx.tmp, "train", ctx.seed, SPLIT, int(t["videos"]), t["frames"], ctx.dims["feat_dim"],
        int(t["captions_per_video"]), t["words"], ctx.dims["vocab"])

    from vct_tpu_torch.config import Config
    from vct_tpu_torch.convert import load_state_dict_into
    from vct_tpu_torch.train.loop import Trainer
    from vct_tpu_torch.utils import setup_seed

    cfg = Config.from_dict(ctx.program_config(vocab_path, "train", feat_dir, ann))
    setup_seed(cfg.tpu.seed)
    trainer = Trainer(cfg, device=ctx.device, writer=None, log=lambda *_: None)
    weights = make_weights(ctx.dims, ctx.seed, ctx.device, torch.float32)
    report = load_state_dict_into(trainer.model, weights)
    if report["unexpected"] or any(not k.endswith("pos_embedding") for k in report["missing"]):
        raise RuntimeError(f"weights do not fit the model: {report}")
    p0 = {k: w.float() for k, w in weights.items()}
    del weights
    spans = trace.Spans(ctx.trace)
    recorder = None
    if ctx.trace:
        trace.Recorder.warm()
        recorder = trace.Recorder(ctx.tmp, float(t["trace_start_s"]), float(t["trace_seconds"]),
                                  spans)
    feed = Feed(trainer.loaders["train"], int(t["ring_batches"]), spans, recorder)
    trainer.loaders["train"] = feed
    step_fn = trainer.train_step
    if ctx.trace:
        trainer.train_step = spanned(step_fn, spans, "bench.trainer.step")

    # the checked steps: the window's own call and feed, one batch a call
    losses, first_grads = [], {}
    feed.limit = 1
    for step in range(CHECKED_STEPS):
        trainer.train_epoch(0)
        losses += trainer.step_losses
        if step == 0:
            first_grads = first_gradients(trainer)
    from reference.checks import leaf_norms

    change = leaf_norms((name, p.detach().float() - p0[name])
                        for name, p in trainer.model.named_parameters() if name in p0)
    checked_rows = [[(index[v], c) for v, c in rows] for rows in feed.rows]
    del p0
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)

    # the window
    feed.limit, feed.fetched_at, served0 = None, [], feed.served
    setup_s = time.perf_counter() - ctx.t_process
    t0 = time.perf_counter()
    feed.deadline = t0 + ctx.seconds
    if recorder is not None:
        recorder.begin(t0)
    epoch = 1
    with HostWatch() as host:
        while time.perf_counter() < feed.deadline:
            trainer.train_epoch(epoch)  # ends on its losses' fetch: a device sync
            epoch += 1
    window_s = time.perf_counter() - t0
    if recorder is not None:
        recorder.finish()
    steps = feed.served - served0
    samples = steps * cfg.data.train.batch_size
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    runner_counts = {k: getattr(step_fn, k, None) for k in ("graphs", "replays")}
    trace_obj = recorder.result() if recorder is not None else None
    gaps = [b - a for a, b in zip(feed.fetched_at, feed.fetched_at[1:])]
    lines = (f"train window: {steps} steps of {cfg.data.train.batch_size} in {window_s:.3f} s, "
             f"{samples / window_s:.1f} samples/s over {len(feed.batches)} batches built "
             f"ahead; step runner {runner_counts}",
             "train window by 5 s: samples/s, ms between fetches p50 / p90 / max: " + "; ".join(
                 f"{len(w) * cfg.data.train.batch_size / 5.0:.0f}, {1e3 * percentile(w, 0.5):.2f} / "
                 f"{1e3 * percentile(w, 0.9):.2f} / {1e3 * max(w, default=0.0):.2f}"
                 for w in segments(feed.fetched_at[1:], gaps, t0, ctx.seconds)),
             host.line())
    # the per-layer readers take the window's part before the recording
    # started (the profiler slows the host): its steps and seconds
    cut = recorder.t_asked if recorder is not None and recorder.t_asked else t0 + window_s
    records = {"steps": sum(at < cut for at in feed.fetched_at), "window_s": cut - t0,
               "batch": cfg.data.train.batch_size}

    # the program's state goes before the reference runs
    lr = cfg.train.optimizer.learning_rate
    dropout, dropout_seed = cfg.model.dropout, cfg.tpu.seed
    del trainer, feed, step_fn
    release(ctx.device)
    records["checked"] = {"rows": checked_rows, "lr": lr, "dropout": dropout,
                          "dropout_seed": dropout_seed}
    checks = judge(ctx, {"losses": losses, "grads": first_grads, "change_norms": change},
                   checked_rows, lr=lr, dropout=dropout, dropout_seed=dropout_seed)
    return Outcome(e2e={"train_samples_per_s": samples / window_s, "setup_s": setup_s},
                   attempted=steps, failed=0, checks=checks, memory_peak_bytes=peak,
                   trace=trace_obj, records=records, lines=lines)


def _reference(ctx: Context, rows, precision: str, *, lr: float, dropout: float,
               dropout_seed: int, rows_kept: slice = slice(None)):
    from reference import checks as ref_checks

    batches = [ref_checks.train_batch(ctx.dims, ctx.seed, SPLIT, r, ctx.traffic["frames"],
                                      ctx.device) for r in rows]
    return ref_checks.train_reference(ctx.dims, ctx.seed, batches, ctx.device, lr=lr,
                                      dropout=dropout, dropout_seed=dropout_seed,
                                      precision=precision, rows=rows_kept)


def judge(ctx: Context, program, rows, **hyper) -> Dict[str, float]:
    """The checked steps against the reference's three steps on the same
    batches (``reference.checks.train_gaps``)."""
    from reference import checks as ref_checks

    return ref_checks.train_gaps(program, _reference(ctx, rows, "float32", **hyper))


def judge_control(ctx: Context, out: Outcome) -> Dict[str, float]:
    """The control's readings: the reference's three steps in fp8, in the
    program's place, against the float32 reference's."""
    from reference import checks as ref_checks

    c = dict(out.records["checked"])
    rows = c.pop("rows")
    losses, grads, change = _reference(ctx, rows, "fp8", **c)
    return ref_checks.train_gaps({"losses": losses, "grads": grads, "change_norms": change},
                                 _reference(ctx, rows, "float32", **c))


def judge_faults(ctx: Context, out: Outcome) -> Dict[str, Dict[str, float]]:
    """Faults planted in the reference put in the program's place: half of
    each batch left out, the mean taken over the rest; and a step that
    returns its state unchanged (no update)."""
    from reference import checks as ref_checks

    c = dict(out.records["checked"])
    rows = c.pop("rows")
    truth = _reference(ctx, rows, "float32", **c)
    half = slice(0, len(rows[0]) // 2)
    faults = {"half_batch": _reference(ctx, rows, "float32", rows_kept=half, **c),
              "state_unchanged": _reference(ctx, rows, "float32", **{**c, "lr": 0.0})}
    return {name: ref_checks.train_gaps({"losses": losses, "grads": grads,
                                         "change_norms": change}, truth)
            for name, (losses, grads, change) in faults.items()}
