"""PTB-style caption tokenizer.

The reference scores through ``pycocoevalcap``'s ``PTBTokenizer``, which
shells out to the Stanford CoreNLP **Java** jar (``eval.py:73-75``;
README requires a JRE). This is a dependency-free Python reimplementation of
the behavior that matters for caption scoring: lowercase, Penn-Treebank-style
word/contraction splitting, and removal of the same punctuation token set the
coco tokenizer drops. Both hypotheses and references pass through the same
tokenizer, so metric comparisons stay internally consistent.
"""

from __future__ import annotations

import re
from typing import Dict, List

# the punctuation tokens pycocoevalcap removes after tokenization
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# contractions the PTB tokenizer splits off the preceding word
_CONTRACTIONS = re.compile(r"(n't|'ll|'re|'ve|'s|'m|'d)$", re.IGNORECASE)

# whole words the PTB tokenizer splits in two (CoreNLP PTBTokenizer's
# special-case list for PTB3 conventions)
_SPECIAL_SPLITS = {
    "cannot": ("can", "not"),
    "gonna": ("gon", "na"),
    "gotta": ("got", "ta"),
    "wanna": ("wan", "na"),
    "lemme": ("lem", "me"),
    "gimme": ("gim", "me"),
    "'tis": ("'t", "is"),
    "'twas": ("'t", "was"),
}

_TOKEN = re.compile(
    # archaic leading-apostrophe contractions FIRST so the special-split
    # table can fire on them (a bare "'" would otherwise split off as punct
    # and the ("'t", ...) PTB outputs could never be produced)
    r"(?i:'t(?:is|was))\b"
    # decimal/grouped numbers before words: '3.5'
    # must not split at the period the word pattern can't cross
    r"|\d+(?:[.,]\d+)+"
    # words: unicode letters AND digits ([^\W_] = \w minus underscore), so
    # '5th', 'mp3', '4x4' and accented words ('café') stay one token like
    # CoreNLP's PTBTokenizer; hyphenated compounds stay ONE token
    # ('well-known'); words may carry an attached contraction
    r"|[^\W_]+(?:-[^\W_]+)*(?:'[a-zA-Z]+)?"
    r"|\.\.\.|--"  # multi-char punct
    r"|[^\w\s]"  # single punct
)

# CoreNLP's PTBTokenizer normalizes typographic Unicode punctuation before
# tokenizing (quotes to ``/'', dashes to --); without this, a curly
# apostrophe blocks contraction splitting and curly quotes leak into the
# n-grams as tokens the coco filter never drops.
_UNICODE_QUOTES = str.maketrans({
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
})
_UNICODE_SEPS = (("—", " -- "), ("–", " -- "), ("…", " ... "))


# Stanford PTBTokenizer escapes brackets and converts straight quotes; the
# escape forms are all in PUNCTUATIONS and get dropped by the coco filter.
# Emitting the raw characters instead would LEAK them into the n-grams.
_PTB_ESCAPES = {
    "(": "-LRB-", ")": "-RRB-", "[": "-LRB-", "]": "-RRB-",
    "{": "-LCB-", "}": "-RCB-", '"': "''",
}


# fast path: a caption that is single-space-separated lowercase ascii words
# tokenizes to exactly its split() (no escapes, no case folding, no
# punctuation, no contractions — the apostrophe-free contraction patterns
# can't fire), unless a word is on the special-split list
_PLAIN = re.compile(r"[a-z]+(?: [a-z]+)*\Z")


def tokenize_caption(text: str) -> List[str]:
    if _PLAIN.fullmatch(text):
        ws = text.split(" ")
        if not any(w in _SPECIAL_SPLITS for w in ws):
            return ws
    text = text.translate(_UNICODE_QUOTES)
    for ch, repl in _UNICODE_SEPS:
        if ch in text:
            text = text.replace(ch, repl)
    out: List[str] = []
    for tok in _TOKEN.findall(text.replace("\n", " ")):
        if tok in _PTB_ESCAPES:
            out.append(_PTB_ESCAPES[tok])
            continue
        tok = tok.lower()
        if tok in _SPECIAL_SPLITS:
            out.extend(_SPECIAL_SPLITS[tok])
            continue
        m = _CONTRACTIONS.search(tok)
        if m and m.start() > 0:
            out.append(tok[: m.start()])
            out.append(tok[m.start() :])
        else:
            out.append(tok)
    return [t for t in out if t not in PUNCTUATIONS]


def tokenize(captions_for_image: Dict[str, List[dict]]) -> Dict[str, List[str]]:
    """coco interface: {id: [{'caption': str}, ...]} -> {id: [tokenized str]}."""
    return {
        img_id: [" ".join(tokenize_caption(c["caption"])) for c in caps]
        for img_id, caps in captions_for_image.items()
    }
