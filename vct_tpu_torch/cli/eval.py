"""Evaluation CLI (port of ``vct_tpu/cli/eval.py``).

    python -m vct_tpu_torch.cli.eval -c configs/msvd.json -m ckpt.pth [--beam 4]

``-c`` config + ``-m`` checkpoint: decode the eval split, score Bleu1-4 /
METEOR / ROUGE_L / CIDEr. Decoding is one KV-cached batch at a time on the
decode kernels, greedy or (``--beam N``) beam search; the checkpoint is a
reference ``.pth`` state dict or a train-state ``.pt`` of
``vct_tpu_torch.cli.train``. Device flags as in the training CLI: ``--gpu``,
the default, is cuda:0 and fails without a card; ``--cpu`` asks for the host.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from vct_tpu_torch.cli.common import (
    add_device_args,
    load_checkpoint_into,
    load_config,
    make_trainer_pieces,
    print_scores,
    resolve_device,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a checkpoint on the eval split")
    p.add_argument("-c", "--config", required=True, type=str,
                   help="The path of '.json' config file")
    p.add_argument("-m", "--model", required=True, type=str,
                   help="checkpoint: reference .pth or a train-state .pt")
    p.add_argument("--beam", type=int, default=0,
                   help="beam size (0 = greedy, the reference's only mode)")
    p.add_argument("--out", type=str, default=None,
                   help="write {vid: caption} predictions JSON here")
    p.add_argument("--metrics_out", type=str, default=None,
                   help="write the metric dict as JSON here (for harnesses)")
    p.add_argument("--per_video", action="store_true",
                   help="also print per-video scores (reference COCOScorer keeps them)")
    p.add_argument("--baseline", choices=sorted(PUBLISHED), default=None,
                   help="diff the scores against the reference repo's "
                        "published test-split numbers")
    add_device_args(p)
    return p


# The reference's published test-split metrics (x100 scale), from its README's
# model zoo: the parity targets.
PUBLISHED = {
    "msvd": {"Bleu_4": 58.0, "METEOR": 39.9, "ROUGE_L": 77.0, "CIDEr": 113.8},
    "msrvtt": {"Bleu_4": 48.1, "METEOR": 31.1, "ROUGE_L": 65.1, "CIDEr": 60.2},
}


def diff_baseline(scores: Dict[str, float], dataset: str, log=print) -> Dict[str, float]:
    """Print and return metric deltas (ours - published, x100 scale), so a
    user with the real data and a ported checkpoint can check parity in one
    command: ``python -m vct_tpu_torch.cli.eval -c cfg.json -m ckpt.pth
    --baseline msvd``."""
    ref = PUBLISHED[dataset]
    deltas = {}
    log(f"--- vs published {dataset} test-split numbers (the reference's README) ---")
    for name, pub in ref.items():
        ours = float(scores.get(name, float("nan"))) * 100.0
        deltas[name] = ours - pub
        log(f"{name:8s} ours {ours:6.1f}  published {pub:6.1f}  "
            f"delta {ours - pub:+6.1f}")
    log("note: the METEOR delta includes a scorer-table difference, not just "
        "model quality — the published number came from the Java METEOR 1.5 "
        "jar's WordNet synonym stage; this scorer uses a bundled synonym "
        "table (vct_tpu_torch/evalcap/meteor_data.py). Bleu/ROUGE_L/CIDEr are "
        "table-free and directly comparable.")
    return deltas


def evaluate(cfg, ckpt_path: str, beam: int = 0, *, device: torch.device,
             log=print) -> Dict[str, float]:
    """Programmatic entry. Returns the metric dict; predictions at
    ``evaluate.predictions``."""
    from vct_tpu_torch.data.loader import build_dataloader
    from vct_tpu_torch.decode import (
        detokenize_batch,
        make_auto_beam_fn,
        make_auto_greedy_fn,
        pipelined_map,
    )
    from vct_tpu_torch.evalcap.scorer import COCOScorer, make_coco_sample
    from vct_tpu_torch.train.step import batch_to_arrays

    model, tokenizer = make_trainer_pieces(cfg, device)
    load_checkpoint_into(model, ckpt_path, log=log, cfg=cfg)
    model.to_compute_dtype()

    ds, loader = build_dataloader(cfg.data.eval, cfg.tpu)
    if beam > 0:
        decode_fn = make_auto_beam_fn(model, cfg.test.max_length, tokenizer.start_id,
                                      tokenizer.end_id, beam)
    else:
        decode_fn = make_auto_greedy_fn(model, cfg.test.max_length, tokenizer.start_id,
                                        tokenizer.end_id)

    def _launch(batch):
        arrays = batch_to_arrays(batch, device)
        return decode_fn(arrays["feats"], arrays["masks"])[0]

    vid2result: Dict[str, str] = {}
    for batch, tokens in pipelined_map(_launch, loader):
        caps = detokenize_batch(tokenizer, tokens)
        for vid, cap in list(zip(batch.vids, caps))[: batch.n_valid]:
            vid2result[vid] = cap

    gts, samples, ids = make_coco_sample(vid2result, ds.video2caption)
    scorer = COCOScorer(verbose=False)
    scores = dict(scorer.score(gts, samples, ids))
    evaluate.predictions = vid2result
    evaluate.per_video = scorer.imgToEval
    evaluate.meteor_provenance = scorer.meteor_provenance
    return scores


def main(argv=None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args)

    from vct_tpu_torch.utils import setup_seed

    cfg = load_config(args.config)
    setup_seed(cfg.tpu.seed)

    scores = evaluate(cfg, args.model, beam=args.beam, device=device)
    print_scores(scores)
    if args.baseline:
        diff_baseline(scores, args.baseline)
    if args.per_video:
        print(json.dumps(evaluate.per_video, indent=2, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(evaluate.predictions, f, indent=2, ensure_ascii=False)
        print(f"wrote predictions to {args.out}")
    if args.metrics_out:
        record = {k: float(v) for k, v in scores.items()}
        # which synonym table produced the METEOR value, read back from the
        # scorer that ran
        record["_meteor_synonyms"] = evaluate.meteor_provenance
        with open(args.metrics_out, "w") as f:
            json.dump(record, f, indent=2)
        print(f"wrote metrics to {args.metrics_out}")
    return scores


if __name__ == "__main__":
    main()
