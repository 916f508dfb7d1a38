"""Self-contained BERT WordPiece tokenizer + caption preprocessor.

Replaces the reference's HF ``AutoTokenizer`` wrapper
(``model/CapPreprocessor.py``) with a dependency-free
implementation of the BERT tokenization algorithm (basic tokenization +
greedy longest-match WordPiece), so the framework never downloads from the
HF hub at runtime — it only needs a ``vocab.txt``. Output ids are identical
to ``bert-base-uncased`` given its vocab file: ``[PAD]=0, [CLS]=101,
[SEP]=102`` (``CapPreprocessor.py:13-15``).

CJK characters are split to single tokens (as BERT's BasicTokenizer does),
which also covers the VATEX/Chinese-tokenizer variant
(``dataloader.py:113-151``) given a ``bert-base-chinese``
vocab.

The preprocessor departs from the reference in one structural way: the
reference tokenizes *inside the model's forward pass* and pads to the batch
max (``MMT4Caption.py:118``; ``CapPreprocessor.py:25-36``); here tokenization
is input-pipeline work producing **static-width** ``[B, S]`` rectangles so the
jitted TPU step is pure tensor ops (SURVEY.md §3.4 note).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicode doesn't.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


# ASCII fast-path table for _clean: \t\n\r -> space, other controls (0-31,
# 127) and NUL deleted, everything else kept — exactly what the per-char
# loop does for ASCII input, at str.translate speed
_ASCII_CLEAN = {i: None for i in range(32)}
_ASCII_CLEAN[0x7F] = None
for _ws in ("\t", "\n", "\r"):
    _ASCII_CLEAN[ord(_ws)] = " "


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT tokenization: basic (clean/lowercase/strip accents/punct-split/CJK
    spacing) + greedy longest-match-first WordPiece with ``##`` continuations."""

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.start_id = vocab[CLS]
        self.end_id = vocab[SEP]

    # -- construction --------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, do_lower_case)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenization ---------------------------------------------------

    def _clean(self, text: str) -> str:
        if text.isascii():
            return text.translate(_ASCII_CLEAN)
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        if text.isascii():  # no CJK codepoints below 128
            return text
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        # alphanumeric chars (any script) are category L*/N*, never P*, and
        # never in BERT's ASCII punctuation ranges — no split possible
        if token.isalnum():
            return [token]
        out: List[List[str]] = []
        new_word = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._space_cjk(self._clean(text))
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                if not tok.isascii():  # NFD is the identity on ASCII
                    tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    # -- wordpiece -------------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    # -- encode / decode ---------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.start_id] + ids + [self.end_id]
        return ids

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), UNK) for i in ids]

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        """HF semantics: join with spaces, fuse ``##`` continuations
        (used at ``MMT4Caption.py:182-183``)."""
        return " ".join(tokens).replace(" ##", "").strip()

    def decode_caption(self, ids: Sequence[int]) -> str:
        """Reference greedy-decode postprocessing (``MMT4Caption.py:174-183``):
        truncate at the first [SEP] — or drop the last token when generation
        hit max length without one — skip position 0 ([CLS]), detokenize, then
        strip any interior [CLS]/[SEP] literals (``eval.py:141``)."""
        ids = list(ids)
        end = -1
        for i, t in enumerate(ids):
            if t == self.end_id:
                end = i
                break
        body = ids[1:end] if end >= 0 else ids[1:-1]
        text = self.convert_tokens_to_string(self.convert_ids_to_tokens(body))
        return text.replace("[CLS]", "").replace("[SEP]", "").strip()


class CaptionPreprocessor:
    """Batch captions -> static-shape ``(ids [B, S], pad_mask [B, S])``.

    Mask convention True = PAD, matching the reference
    (``CapPreprocessor.py:35``). Captions longer than ``max_len`` are truncated
    but always end with [SEP].
    """

    def __init__(self, tokenizer: WordPieceTokenizer, max_len: int = 32):
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.pad_id = tokenizer.pad_id
        self.start_id = tokenizer.start_id
        self.end_id = tokenizer.end_id

    def __call__(self, captions: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        b = len(captions)
        ids = np.full((b, self.max_len), self.pad_id, dtype=np.int32)
        for i, cap in enumerate(captions):
            enc = self.tokenizer.encode(cap)
            if len(enc) > self.max_len:
                enc = enc[: self.max_len - 1] + [self.end_id]
            ids[i, : len(enc)] = enc
        mask = ids == self.pad_id
        return ids, mask


def make_tokenizer(
    vocab_path: Optional[str] = None, tokenizer_name: str = "bert-base-uncased"
) -> WordPieceTokenizer:
    """Build a tokenizer from a vocab file; fall back to a locally cached HF
    tokenizer's vocab if available (never downloads)."""
    if vocab_path:
        # HF convention: '-cased' models keep case; 'bert-base-chinese' is
        # ALSO cased (its tokenizer_config sets do_lower_case=false) despite
        # lacking the substring — without this, Latin words in VATEX-style
        # Chinese captions get lowercased to different ids than HF produces
        name = tokenizer_name.lower()
        do_lower = ("uncased" in name
                    or ("cased" not in name and "chinese" not in name))
        return WordPieceTokenizer.from_vocab_file(vocab_path, do_lower_case=do_lower)
    try:  # pragma: no cover - environment dependent
        from transformers import AutoTokenizer

        hf = AutoTokenizer.from_pretrained(tokenizer_name, local_files_only=True)
        return WordPieceTokenizer(dict(hf.get_vocab()), do_lower_case=getattr(hf, "do_lower_case", True))
    except Exception as e:  # noqa: BLE001
        raise FileNotFoundError(
            "No vocab_path configured (tpu.vocab_path) and no locally cached "
            f"HF tokenizer for {tokenizer_name!r}: {e}"
        )
