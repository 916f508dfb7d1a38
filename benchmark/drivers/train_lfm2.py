"""Training the LFM2 caption LM: ``Trainer.train_epoch`` as ``cli.train``
builds the Trainer from a configuration with a ``model.caption_lm`` section.

As ``drivers/train.py`` does for the MSVD decoder: set-up writes the train
split (seeded features and captions) and a synthetic vocabulary of the LM's
size, builds the Trainer, loads the seed's float32 master weights
(``benchlib.lfm2.make_weights``) through the port's loader, has the Trainer's
loader build the first batches of its epoch, and drives the same object
through its first three steps (the first eager and captured, the next two
replayed). After each of them the driver copies each MoE layer's choice of
experts (``SparseMoE.last_idx``) to the host. The window then runs epochs
until ``seconds`` have passed; the last ends on its loss fetch.

The check (``reference/lfm2.py``, float32, TF32 off) follows the three
steps from the same master weights on the same batches, with the program's
experts for each token (so a near-tie that the two break apart does not move
the loss): ``loss_gap``, ``later_loss_gap``, ``grad_gap``, ``grad_error``,
``change_gap`` as ``reference.checks.train_gaps`` has them, each expert of a
layer a leaf of its own; and ``route_mismatch``, the share of (real position,
MoE layer, step) whose set of experts differs from the reference's own top k,
left out where the reference's k-th and (k+1)-th scores lie within
``NEAR_TIE_ROUTE`` of each other.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

from benchlib import data, trace
from benchlib.context import Context, Outcome, release
from benchlib.hoststats import HostWatch, percentile, segments

SPLIT = 0
CHECKED_STEPS = 3
NEAR_TIE_ROUTE = 0.06   # routing scores closer than this are a tie that rounding may break


def _drv():
    from benchlib.cells import BENCH_DIR, load_module

    return load_module(os.path.join(BENCH_DIR, "drivers", "train.py"), "bench_driver_train")


def lfm2_leaves(name: str, t):
    """Logical leaves: each expert of an expert tensor alone, a packed
    attention in-projection as its three parts."""
    from reference.checks import logical_leaves

    if name.endswith((".experts.w13", ".experts.w2")):
        return [(f"{name}[{e}]", t[e]) for e in range(t.shape[0])]
    return logical_leaves(name, t)


def leaf_norms(tensors) -> Dict[str, float]:
    return {k: float(v.norm()) for name, t in tensors for k, v in lfm2_leaves(name, t)}


def first_gradients(trainer):
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    state = trainer.optimizer.state
    return {k: v for name, p in trainer.model.named_parameters()
            if "exp_avg" in state.get(p, {})
            for k, v in lfm2_leaves(name, (state[p]["exp_avg"] / (1 - beta1)).cpu())}


def run(ctx: Context) -> Outcome:
    import torch

    import vct_tpu_torch.models.lfm2  # noqa: F401 (a program without the LM stops here)
    from benchlib import lfm2

    t = ctx.traffic
    dims = lfm2.dims_of(ctx.cell.config)
    vocab_path = os.path.join(ctx.tmp, "vocab.txt")
    data.write_vocab(vocab_path, dims["vocab"])
    feat_dir, ann, index = data.write_split(
        ctx.tmp, "train", ctx.seed, SPLIT, int(t["videos"]), t["frames"], dims["feat_dim"],
        int(t["captions_per_video"]), t["words"], dims["vocab"])

    from vct_tpu_torch.config import Config
    from vct_tpu_torch.convert import load_state_dict_into
    from vct_tpu_torch.train.loop import Trainer
    from vct_tpu_torch.utils import setup_seed

    cfg = Config.from_dict(ctx.program_config(vocab_path, "train", feat_dir, ann))
    setup_seed(cfg.tpu.seed)
    trainer = Trainer(cfg, device=ctx.device, writer=None, log=lambda *_: None)
    weights = lfm2.make_weights(dims, ctx.seed, ctx.device)
    report = load_state_dict_into(trainer.model, weights)
    if report["unexpected"] or any(not k.endswith("pos_embedding") for k in report["missing"]):
        raise RuntimeError(f"weights do not fit the model: {report}")
    p0 = dict(weights)
    del weights
    moes = trainer.model.cap_decoder.moe_layers()
    tokens_per_step = cfg.data.train.batch_size * lfm2.positions(dims, 1)[1]
    spans = trace.Spans(ctx.trace)
    recorder = None
    if ctx.trace:
        trace.Recorder.warm()
        recorder = trace.Recorder(ctx.tmp, float(t["trace_start_s"]), float(t["trace_seconds"]),
                                  spans)
    drv = _drv()
    feed = drv.Feed(trainer.loaders["train"], int(t["ring_batches"]), spans, recorder)
    trainer.loaders["train"] = feed
    step_fn = trainer.train_step
    if ctx.trace:
        trainer.train_step = drv.spanned(step_fn, spans, "bench.trainer.step")

    # the checked steps, and each one's choice of experts
    losses, first_grads, choices = [], {}, []
    feed.limit = 1
    for step in range(CHECKED_STEPS):
        trainer.train_epoch(0)
        losses += trainer.step_losses
        choices.append([m.last_idx[tokens_per_step].cpu().clone() for m in moes])
        if step == 0:
            first_grads = first_gradients(trainer)
    change = leaf_norms((name, p.detach() - p0[name])
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
    batch = cfg.data.train.batch_size
    samples = steps * batch
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    rows_per_expert = [m.rows_per_expert.cpu().tolist() for m in moes]
    runner_counts = {k: getattr(step_fn, k, None) for k in ("graphs", "replays")}
    trace_obj = recorder.result() if recorder is not None else None
    gaps = [b - a for a, b in zip(feed.fetched_at, feed.fetched_at[1:])]
    lines = (f"train window: {steps} steps of {batch} in {window_s:.3f} s, "
             f"{samples / window_s:.1f} samples/s, {1e3 * window_s / max(steps, 1):.2f} ms a "
             f"step over {len(feed.batches)} batches built ahead; step runner {runner_counts}",
             "train window by 5 s: samples/s, ms between fetches p50 / p90 / max: " + "; ".join(
                 f"{len(w) * batch / 5.0:.0f}, {1e3 * percentile(w, 0.5):.2f} / "
                 f"{1e3 * percentile(w, 0.9):.2f} / {1e3 * max(w, default=0.0):.2f}"
                 for w in segments(feed.fetched_at[1:], gaps, t0, ctx.seconds)),
             "rows per expert in the last step, by MoE layer (min / median / max of "
             f"{dims['experts']}): " + "; ".join(
                 f"{min(r)} / {sorted(r)[len(r) // 2]} / {max(r)}" for r in rows_per_expert),
             host.line())
    cut = recorder.t_asked if recorder is not None and recorder.t_asked else t0 + window_s
    records = {"steps": sum(at < cut for at in feed.fetched_at), "window_s": cut - t0,
               "batch": batch, "rows_per_expert": rows_per_expert}

    lr = cfg.train.optimizer.learning_rate
    del trainer, feed, step_fn, moes
    release(ctx.device)
    records["checked"] = {"rows": checked_rows, "lr": lr, "choices": choices}
    checks, parted, counted = judge(ctx, {"losses": losses, "grads": first_grads,
                                          "change_norms": change}, checked_rows, choices, lr=lr)
    lines += (f"routing: {len(parted)} (real position, MoE layer, step) of the checked steps "
              f"choose other experts than the reference; their reference gaps between the "
              f"k-th and (k+1)-th scores, largest first: "
              f"{', '.join(f'{g:.2e}' for g in parted[:8]) or 'none'}; route_mismatch counts "
              f"{100 * counted:.2f}% of the real (position, MoE layer, step), the rest near-ties",)
    return Outcome(e2e={"train_samples_per_s": samples / window_s, "setup_s": setup_s},
                   attempted=steps, failed=0, checks=checks, memory_peak_bytes=peak,
                   trace=trace_obj, records=records, lines=lines)


# ---- the check -------------------------------------------------------------------


def _batches(ctx: Context, dims, rows):
    from reference import checks as ref_checks

    return [ref_checks.train_batch(dims, ctx.seed, SPLIT, r, ctx.traffic["frames"], ctx.device)
            for r in rows]


def train_reference(ctx: Context, dims, rows, choices, precision: str, *, lr: float,
                    keep: slice = slice(None)):
    """Three Adam steps of the reference from the seed's master weights on
    the checked batches, each with ``choices`` (per step, per MoE layer, the
    experts of every token; None: the reference's own) -> (losses, first
    gradient by leaf, change norm by leaf, per step the (own top k, gap)
    records of each MoE layer). ``keep`` keeps part of each batch (a fault)."""
    import torch

    from benchlib import lfm2
    from reference import checks as ref_checks
    from reference import lfm2 as ref

    ref.no_tf32()
    w0 = lfm2.make_weights(dims, ctx.seed, ctx.device)
    trained = [k for k in w0 if not k.startswith("matching.") and not k.endswith("expert_bias")]
    w = {k: (v.clone().requires_grad_(True) if k in trained else v) for k, v in w0.items()}
    prec = ref.Precision(precision)
    m = {k: torch.zeros_like(w[k]) for k in trained}
    v = {k: torch.zeros_like(w[k]) for k in trained}
    b1, b2 = ref_checks.ADAM_BETAS
    losses, first, records = [], {}, []
    n = lfm2.positions(dims, 1)[1]
    for step, (x, pad, ids) in enumerate(_batches(ctx, dims, rows), start=1):
        choice = None
        if choices is not None:
            k = dims["top_k"]
            choice = [c.to(ctx.device).long().view(x.shape[0], n, k)[keep].reshape(-1, k)
                      for c in choices[step - 1]]
        rec: List = []
        loss = ref.caption_loss(w, dims, x[keep], pad[keep], ids[keep], prec, choice, rec)
        records.append(rec)
        grads = torch.autograd.grad(loss, [w[k] for k in trained])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 1:
                first = {k2: g2 for name, g in zip(trained, grads)
                         for k2, g2 in lfm2_leaves(name, g)}
            for k, g in zip(trained, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** step)).sqrt() + ref_checks.ADAM_EPS
                w[k] -= lr * (m[k] / (1 - b1 ** step)) / denom
        del grads, loss
    change = leaf_norms((k, w[k].detach() - w0[k]) for k in trained)
    return losses, first, change, records


def route_mismatch(ctx: Context, dims, rows, choices, records):
    """-> (the share of (real position, MoE layer, step) whose experts
    differ from the reference's own top k, near-ties left out; the
    reference's gaps between its k-th and (k+1)-th scores at every real
    position whose experts differ, ties included, largest first; the share
    of real (position, MoE layer, step) that the first share counts)."""
    import torch

    from reference import lfm2 as ref

    bad = total = n_real = 0
    gaps = []
    for (x, pad, ids), step_choice, step_rec in zip(_batches(ctx, dims, rows), choices, records):
        mem_pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
        real = ref.real_positions(mem_pad, ids[:, :-1], dims["pad_id"]).cpu()
        for chosen, (own, gap) in zip(step_choice, step_rec):
            differ = (chosen.cpu().long().sort(dim=1).values
                      != own.cpu().long().sort(dim=1).values).any(dim=1)
            gap = gap.cpu()
            counted = real & (gap >= NEAR_TIE_ROUTE)
            bad += int((differ & counted).sum())
            total += int(counted.sum())
            n_real += int(real.sum())
            gaps += gap[real & differ].tolist()
    return bad / max(total, 1), sorted(gaps, reverse=True), total / max(n_real, 1)


def _gaps(ctx, dims, rows, program, choices, truth):
    """-> (the checks, the gaps of the positions whose experts differ, the
    share of real positions that ``route_mismatch`` counts)."""
    from reference import checks as ref_checks

    losses, first, change, records = truth
    out = ref_checks.train_gaps(program, (losses, first, change))
    out["route_mismatch"], parted, counted = route_mismatch(ctx, dims, rows, choices, records)
    return out, parted, counted


def judge(ctx: Context, program, rows, choices, *, lr: float):
    """-> (the checks, the gaps of the positions whose experts differ, the
    share of real positions that ``route_mismatch`` counts)."""
    from benchlib import lfm2

    dims = lfm2.dims_of(ctx.cell.config)
    truth = train_reference(ctx, dims, rows, choices, "float32", lr=lr)
    return _gaps(ctx, dims, rows, program, choices, truth)


def judge_control(ctx: Context, out: Outcome) -> Dict[str, float]:
    """The control in the program's place: the reference in fp8 with its
    own experts, against the float32 reference given those experts."""
    from benchlib import lfm2

    dims = lfm2.dims_of(ctx.cell.config)
    c = out.records["checked"]
    losses, first, change, records = train_reference(ctx, dims, c["rows"], None, "fp8",
                                                     lr=c["lr"])
    choices = [[own.cpu() for own, _ in rec] for rec in records]
    truth = train_reference(ctx, dims, c["rows"], choices, "float32", lr=c["lr"])
    out, parted, counted = _gaps(ctx, dims, c["rows"], {"losses": losses, "grads": first,
                                                        "change_norms": change}, choices, truth)
    return {**out, "route_parted": len(parted), "route_parted_gap_max": max(parted, default=0.0),
            "route_counted_share": counted}


def judge_faults(ctx: Context, out: Outcome) -> Dict[str, Dict[str, float]]:
    """Faults planted in the float32 reference put in the program's place:
    half of each batch left out; a step that returns its state unchanged;
    routing that drops ``expert_bias`` (its own choice of experts against
    the reference's top k given that choice)."""
    from benchlib import lfm2

    dims = lfm2.dims_of(ctx.cell.config)
    c = out.records["checked"]
    truth = train_reference(ctx, dims, c["rows"], c["choices"], "float32", lr=c["lr"])
    half = slice(0, len(c["rows"][0]) // 2)
    faults = {"half_batch": train_reference(ctx, dims, c["rows"], c["choices"], "float32",
                                            lr=c["lr"], keep=half),
              "state_unchanged": train_reference(ctx, dims, c["rows"], c["choices"],
                                                 "float32", lr=0.0)}
    from reference import checks as ref_checks

    out_ = {name: ref_checks.train_gaps({"losses": f[0], "grads": f[1], "change_norms": f[2]},
                                        truth[:3])
            for name, f in faults.items()}
    unbiased = train_reference(ctx, {**dims, "use_expert_bias": False}, c["rows"], None,
                               "float32", lr=c["lr"])
    chosen = [[own.cpu() for own, _ in rec] for rec in unbiased[3]]
    held = train_reference(ctx, dims, c["rows"], chosen, "float32", lr=c["lr"])
    share, _, counted = route_mismatch(ctx, dims, c["rows"], chosen, held[3])
    out_["expert_bias_dropped"] = {"route_mismatch": share, "route_counted_share": counted}
    return out_
