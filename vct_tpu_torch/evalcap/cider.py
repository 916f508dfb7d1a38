"""CIDEr, matching pycocoevalcap's ``Cider`` (``eval.py:87``): the CIDEr-D
formulation that tool actually computes — TF-IDF n-gram vectors (n=1..4, IDF
from the reference corpus), clipped cosine similarity per n, Gaussian length
penalty (sigma=6), averaged over n and references, scaled by 10.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple


def _ngram_counts(sentence: str, n: int = 4) -> Counter:
    words = sentence.split()
    counts: Counter = Counter()
    for k in range(1, n + 1):
        # C-speed ngram iteration; same tuples as the index loop
        counts.update(zip(*(words[i:] for i in range(k))))
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[float, List[float]]:
        ids = list(gts.keys())
        if not ids:  # empty corpus: mirror the other scorers, not log(0)
            return 0.0, []
        crefs = [[_ngram_counts(r, self.n) for r in gts[i]] for i in ids]
        ctests = [_ngram_counts(res[i][0], self.n) for i in ids]

        # document frequency over reference sets (cider_scorer.compute_doc_freq)
        doc_freq: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in set(g for ref in refs for g in ref):
                doc_freq[ngram] += 1.0
        log_num_images = math.log(float(len(crefs)))
        # idf precomputed once per corpus ngram (captions share most ngrams,
        # so this removes a math.log per (caption, ngram) pair); ngrams never
        # seen in any reference get df=1 -> idf = log N, the same value the
        # per-item max(1, df) produced
        idf = {g: log_num_images - math.log(d) if d > 1.0 else log_num_images
               for g, d in doc_freq.items()}
        idf_get = idf.get

        def counts2vec(cnts: Counter):
            vec = [{} for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                w = float(tf) * idf_get(ngram, log_num_images)
                k = len(ngram) - 1
                vec[k][ngram] = w
                norm[k] += w * w
                if k == 0:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr) -> List[float]:
            delta = float(lh - lr)
            penalty = math.exp(-(delta**2) / (2 * self.sigma**2))
            val = [0.0] * self.n
            for k in range(self.n):
                vr_get = vr[k].get
                acc = 0.0
                for ngram, w in vh[k].items():
                    r = vr_get(ngram)
                    if r is not None:
                        # CIDEr-D clipping: min(hyp, ref) * ref
                        acc += (w if w <= r else r) * r
                if nh[k] != 0 and nr[k] != 0:
                    acc /= nh[k] * nr[k]
                val[k] = acc * penalty
            return val

        scores: List[float] = []
        for test, refs in zip(ctests, crefs):
            vh, nh, lh = counts2vec(test)
            acc = [0.0] * self.n
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                for k, v in enumerate(sim(vh, vr, nh, nr, lh, lr)):
                    acc[k] += v
            score_avg = sum(acc) / self.n / len(refs) if refs else 0.0
            scores.append(score_avg * 10.0)
        return sum(scores) / max(len(scores), 1), scores
