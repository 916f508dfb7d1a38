"""Corpus BLEU 1-4, matching pycocoevalcap's ``BleuScorer`` with
``option='closest'`` (the configuration ``eval.py:85`` uses): clipped n-gram
precision aggregated over the corpus, effective reference length chosen
closest to each candidate's length, brevity penalty applied at corpus level,
with the same tiny/small smoothing constants.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

TINY = 1e-15
SMALL = 1e-9


def _ngrams(tokens: List[str], n: int) -> Counter:
    # zip iterates at C speed and stops at the shortest tail, yielding the
    # same len(tokens)-n+1 tuples as the index loop (and nothing when the
    # sentence is shorter than n)
    return Counter(zip(*(tokens[i:] for i in range(n))))


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[List[float], List[List[float]]]:
        n = self.n
        total_correct = [0.0] * n
        total_guess = [0.0] * n
        total_c_len = 0.0
        total_r_len = 0.0
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        ids = list(gts.keys())
        for img_id in ids:
            hyp = res[img_id][0].split()
            refs = [r.split() for r in gts[img_id]]
            c_len = len(hyp)
            # closest reference length (ties -> shorter, matching coco)
            r_len = min((abs(len(r) - c_len), len(r)) for r in refs)[1] if refs else 0
            total_c_len += c_len
            total_r_len += r_len

            correct = [0.0] * n
            guess = [0.0] * n
            for k in range(1, n + 1):
                hyp_counts = _ngrams(hyp, k)
                if len(refs) == 1:
                    max_ref = _ngrams(refs[0], k)
                else:
                    max_ref = Counter()
                    for r in refs:
                        for g, c in _ngrams(r, k).items():
                            if c > max_ref[g]:
                                max_ref[g] = c
                mr_get = max_ref.get
                correct[k - 1] = float(
                    sum(c if c <= (m := mr_get(g, 0)) else m
                        for g, c in hyp_counts.items())
                )
                guess[k - 1] = float(max(0, c_len - k + 1))
                total_correct[k - 1] += correct[k - 1]
                total_guess[k - 1] += guess[k - 1]

            # per-sentence cumulative scores with sentence-level BP
            ratio = c_len / (r_len + SMALL)
            bp = 1.0 if ratio > 1.0 else _safe_exp(1.0 - 1.0 / (ratio + TINY))
            p = 1.0
            for k in range(n):
                p *= (correct[k] + TINY) / (guess[k] + SMALL)
                per_sentence[k].append((p ** (1.0 / (k + 1))) * bp)

        ratio = total_c_len / (total_r_len + SMALL)
        bp = 1.0 if ratio > 1.0 else _safe_exp(1.0 - 1.0 / (ratio + TINY))
        scores: List[float] = []
        p = 1.0
        for k in range(n):
            p *= (total_correct[k] + TINY) / (total_guess[k] + SMALL)
            scores.append((p ** (1.0 / (k + 1))) * bp)
        return scores, per_sentence


def _safe_exp(x: float) -> float:
    return math.exp(max(min(x, 700.0), -700.0))
