"""ROUGE-L, matching pycocoevalcap's ``Rouge`` (``eval.py:86``): LCS-based
precision/recall per reference, max over references, F-beta with beta=1.2,
mean over images.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    bset = set(b)
    prev = [0] * (len(b) + 1)
    for x in a:
        # a row whose word matches nothing in b reproduces the previous row
        # (DP rows are non-decreasing, so max(prev[j], cur[j-1]) == prev[j]
        # all the way across) — skip it
        if x not in bset:
            continue
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, hyp: str, refs: List[str]) -> float:
        h = hyp.split()
        prec, rec = [], []
        for r in refs:
            rt = r.split()
            lcs = _lcs_len(h, rt)
            prec.append(lcs / len(h) if h else 0.0)
            rec.append(lcs / len(rt) if rt else 0.0)
        if not prec:  # empty reference list -> no credit
            return 0.0
        p, r = max(prec), max(rec)
        if p == 0.0 or r == 0.0:
            return 0.0
        b2 = self.beta**2
        return (1 + b2) * p * r / (r + b2 * p)

    def compute_score(
        self, gts: Dict[str, List[str]], res: Dict[str, List[str]]
    ) -> Tuple[float, List[float]]:
        scores = [self.calc_score(res[i][0], gts[i]) for i in gts.keys()]
        return sum(scores) / max(len(scores), 1), scores
