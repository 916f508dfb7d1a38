"""Evaluation decode: the eval CLI's loop (``decode.pipelined_map`` over
``make_auto_beam_fn`` and ``detokenize_batch``) over a seeded test split,
without the COCO scoring, whose numbers mean nothing with random weights.

Set-up writes the split, builds the model as ``cli.eval`` does
(``make_trainer_pieces``, the port's loader, ``to_compute_dtype``) and
decodes the split once (the first call of the batch shape captures the
decode's graphs). The window runs passes over the split until ``seconds``
have passed; a pass ends when its last batch is detokenized. Afterwards a
sample of the captions and scores of the last pass is judged by the float32
reference.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

from benchlib import data, trace
from benchlib.context import Context, Outcome, release

SPLIT = 2  # the test split's number in ``benchlib.data``


def run(ctx: Context) -> Outcome:
    import torch

    from benchlib.weights import make_weights

    t = ctx.traffic
    vocab_path = os.path.join(ctx.tmp, "vocab.txt")
    data.write_vocab(vocab_path, ctx.dims["vocab"])
    feat_dir, ann, index = data.write_split(
        ctx.tmp, "test", ctx.seed, SPLIT, int(t["videos"]), t["frames"], ctx.dims["feat_dim"],
        1, t["words"], ctx.dims["vocab"])

    from vct_tpu_torch.cli.common import make_trainer_pieces
    from vct_tpu_torch.config import Config
    from vct_tpu_torch.convert import load_state_dict_into
    from vct_tpu_torch.data.loader import build_dataloader
    from vct_tpu_torch.decode import detokenize_batch, make_auto_beam_fn, pipelined_map
    from vct_tpu_torch.train.step import batch_to_arrays

    cfg = Config.from_dict(ctx.program_config(vocab_path, "eval", feat_dir, ann))
    model, tokenizer = make_trainer_pieces(cfg, ctx.device)
    weights = make_weights(ctx.dims, ctx.seed, ctx.device)
    report = load_state_dict_into(model, weights)
    if report["unexpected"] or any(not k.endswith("pos_embedding") for k in report["missing"]):
        raise RuntimeError(f"weights do not fit the model: {report}")
    del weights
    model.to_compute_dtype()
    _, loader = build_dataloader(cfg.data.eval, cfg.tpu)
    beam = int(t["beam"])
    decode_fn = make_auto_beam_fn(model, cfg.test.max_length, tokenizer.start_id,
                                  tokenizer.end_id, beam)
    launched: List = []
    spans = trace.Spans(ctx.trace)

    def launch(batch):
        with spans("bench.eval.launch"):
            arrays = batch_to_arrays(batch, ctx.device)
            tokens, scores = decode_fn(arrays["feats"], arrays["masks"])
        launched.append((batch.vids[: batch.n_valid], tokens, scores, time.perf_counter()))
        return tokens

    def one_pass(deadline=None, recorder=None) -> int:
        """Decode the split (or until ``deadline``) -> captions made."""
        made = 0
        batches = iter(loader)
        for batch, tokens in pipelined_map(launch, _until(batches, deadline, recorder)):
            with spans("bench.eval.detokenize"):
                caps = detokenize_batch(tokenizer, tokens)
            made += len(caps[: batch.n_valid])
        return made

    one_pass()  # warm: the batch shape's graphs are captured here
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    launched.clear()
    recorder = None
    if ctx.trace:
        trace.Recorder.warm()
        recorder = trace.Recorder(ctx.tmp, float(t["trace_start_s"]), float(t["trace_seconds"]),
                                  spans)
    setup_s = time.perf_counter() - ctx.t_process
    t0 = time.perf_counter()
    if recorder is not None:
        recorder.begin(t0)
    deadline = t0 + ctx.seconds
    captions, passes = 0, 0
    while time.perf_counter() < deadline:
        captions += one_pass(deadline, recorder)
        passes += 1
    window_s = time.perf_counter() - t0
    if recorder is not None:
        recorder.finish()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    trace_obj = recorder.result() if recorder is not None else None
    lines = (f"eval window: {captions} captions in {window_s:.3f} s over {passes} passes "
             f"({captions / window_s:.1f} captions/s), beam {beam}, batch "
             f"{cfg.data.eval.batch_size}",)

    # the sample: the last decode of each video in the window
    last: Dict[str, tuple] = {}
    for vids, tokens, scores, _ in launched:
        host_t, host_s = tokens.cpu().numpy(), scores.float().cpu().numpy()
        for r, vid in enumerate(vids):
            last[vid] = (host_t[r], float(host_s[r]))
    records = {"launches": [(len(v), tok, ts) for v, tok, _, ts in launched],
               "captions": captions, "window_s": window_s, "beam": beam,
               "batch": cfg.data.eval.batch_size,
               "trace_host": (recorder.t_on, recorder.t_off) if recorder and recorder.t_on else None,
               "index": index, "last": last}
    del model, decode_fn, launched
    release(ctx.device)
    checks = judge(ctx, index, last, beam)
    return Outcome(e2e={"eval_captions_per_s": captions / window_s, "setup_s": setup_s},
                   attempted=captions, failed=0, checks=checks, memory_peak_bytes=peak,
                   trace=trace_obj, records=records, lines=lines)


def judge_control(ctx: Context, out: Outcome) -> Dict[str, float]:
    """The control's readings: the fp8 reference's own beam search on this
    run's sample of videos."""
    return judge(ctx, out.records["index"], out.records["last"], out.records["beam"],
                 precision="fp8")


def _until(batches, deadline, recorder):
    for b in batches:
        if recorder is not None:
            recorder.poll()
        if deadline is not None and time.perf_counter() >= deadline:
            return
        yield b


def judge(ctx: Context, index: Dict[str, int], last: Dict[str, tuple], beam: int,
          precision: str = "float32") -> Dict[str, float]:
    from reference import checks as ref_checks

    vids = sorted(last)
    lengths = [ref_checks.greedy_length(last[v][0]) for v in vids]
    pick = [vids[i] for i in ref_checks.sample_rows(ctx.seed, lengths,
                                                   int(ctx.traffic["check_videos"]))]
    feats = [data.video_features(ctx.seed, SPLIT, index[v], ctx.traffic["frames"],
                                 ctx.dims["feat_dim"]) for v in pick]
    return ref_checks.beam_gaps(ctx.dims, ctx.seed, feats, [last[v][0] for v in pick],
                                [last[v][1] for v in pick], ctx.device, beam=beam,
                                length_penalty=float(ctx.traffic["length_penalty"]),
                                precision=precision)
