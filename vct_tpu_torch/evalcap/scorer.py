"""COCO-style caption scorer: Bleu_1-4, METEOR, ROUGE_L, CIDEr.

Drop-in equivalent of the reference's ``COCOScorer`` (``eval.py:42-122``) and
``make_coco_sample`` (``eval.py:20-39``) with all-Python scorers (no Java):
tokenize gts+res with the PTB-style tokenizer, run each scorer, keep both
corpus scores (``.eval``) and per-video scores (``.imgToEval``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from vct_tpu_torch.evalcap import ptb
from vct_tpu_torch.evalcap.bleu import Bleu
from vct_tpu_torch.evalcap.cider import Cider
from vct_tpu_torch.evalcap.meteor import Meteor
from vct_tpu_torch.evalcap.rouge import Rouge


def make_coco_sample(
    prediction_dict: Dict[str, str], ground_truth_dict: Dict[str, List[str]]
) -> Tuple[Dict, Dict, List[str]]:
    """{vid: caption}, {vid: [refs]} -> (gts, samples, IDs) coco structures."""
    samples, gts, ids = {}, {}, []
    for vid, cap in prediction_dict.items():
        ids.append(vid)
        samples[vid] = [{"image_id": vid, "caption": cap}]
    for vid, caps in ground_truth_dict.items():
        gts[vid] = [{"image_id": vid, "caption": c} for c in caps]
    return gts, samples, ids


_meteor_note_shown = False


class COCOScorer:
    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict[str, Dict] = {}
        # provenance of the synonym table behind the METEOR value; refreshed
        # by score() from the actual Meteor instance so downstream records
        # (cli.eval --metrics_out, bench.py) stay truthful if the scorer is
        # ever constructed with extended_synonyms=True
        from vct_tpu_torch.evalcap.meteor_data import SYNONYM_PROVENANCE

        self.meteor_provenance: str = SYNONYM_PROVENANCE
        # one-time provenance note so METEOR numbers are not accidentally
        # cross-compared with jar-scored papers (round-1 advisor finding)
        global _meteor_note_shown
        if verbose and not _meteor_note_shown:
            _meteor_note_shown = True
            print(f"[scorer] {Meteor.note}")

    def score(self, gts: Dict, res: Dict, ids: Sequence[str]) -> Dict[str, float]:
        gts = {i: gts[i] for i in ids}
        res = {i: res[i] for i in ids}
        gts_tok = ptb.tokenize(gts)
        res_tok = ptb.tokenize(res)

        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        for scorer, method in scorers:
            if isinstance(scorer, Meteor):
                self.meteor_provenance = scorer.provenance
            score, per = scorer.compute_score(gts_tok, res_tok)
            if isinstance(method, list):
                for sc, scs, m in zip(score, per, method):
                    self._set(sc, scs, ids, m)
            else:
                self._set(score, per, ids, method)
            if self.verbose:
                if isinstance(method, list):
                    for sc, m in zip(score, method):
                        print(f"{m}: {sc:0.3f}")
                else:
                    print(f"{method}: {score:0.3f}")
        return self.eval

    def _set(self, score: float, per_image: List[float], ids: Sequence[str], method: str):
        self.eval[method] = score
        for img_id, s in zip(ids, per_image):
            self.imgToEval.setdefault(img_id, {"image_id": img_id})[method] = s


def score_captions(
    predictions: Dict[str, str], references: Dict[str, List[str]], verbose: bool = False
) -> Dict[str, float]:
    """Convenience one-call scoring."""
    gts, samples, ids = make_coco_sample(predictions, references)
    scorer = COCOScorer(verbose=verbose)
    return scorer.score(gts, samples, ids)
