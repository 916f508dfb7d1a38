"""CLIP text tower + self-contained CLIP BPE tokenizer (port of
``vct_tpu/clip/text.py``).

The reference's matching and cross tasks use a *frozen* sentence encoder
(``TextEncoder.py:7-55``): CLIP ViT-B/32 ``encode_text`` (dim 512) or BERT CLS
(dim 768), whose weights never enter checkpoints. The CLIP path here is an
``nn.Module`` text transformer (width 512, 12 layers, 8 heads, causal mask,
EOT-token pooling, projection to 512) built from the vision tower's
``CLIPBlock``, keyed like OpenAI's text state dict (``token_embedding``,
``positional_embedding``, ``transformer.resblocks.N``, ``ln_final``,
``text_projection``), and the byte-level BPE tokenizer (``clip.tokenize``,
context length 77) loading standard ``vocab.json`` + ``merges.txt`` files.
The tokenizer is a copy of the reference's pure-Python one.

The BERT path goes through ``transformers`` from a local directory only.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vct_tpu_torch.clip.convert import first_blocks, hf_to_openai_keys, load_clip_state_dict
from vct_tpu_torch.clip.vision import CLIPTransformer
from vct_tpu_torch.models.layers import layer_norm

CONTEXT_LENGTH = 77  # clip.tokenize default
NEG_INF = -1e30


class CLIPTextTower(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 512, layers: int = 12,
                 heads: int = 8, context_length: int = CONTEXT_LENGTH, out_dim: int = 512,
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width, device=device))
        self.transformer = CLIPTransformer(width, layers, heads, dtype=dtype, device=device)
        self.ln_final = nn.LayerNorm(width, eps=1e-5, device=device)
        self.text_projection = nn.Parameter(torch.empty(width, out_dim, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, context_length] int -> [B, out_dim] (EOT-pooled)."""
        dt = self.dtype
        x = self.token_embedding.weight[tokens.long()].to(dt) + self.positional_embedding[None].to(dt)
        t = tokens.shape[1]
        causal = torch.full((t, t), NEG_INF, device=x.device).triu(1)
        x = layer_norm(self.transformer(x, causal), self.ln_final, dt)
        # pool at the EOT token = highest token id per row (OpenAI CLIP.encode_text)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(dt)


# ---------------------------------------------------------------------------
# BPE tokenizer (clip.simple_tokenizer semantics)
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


# clip.simple_tokenizer uses the ``regex`` module's \p{L}/\p{N} classes; the
# stdlib-re equivalent below matches it exactly on ASCII text (MSR-VTT/MSVD
# captions are ASCII; VATEX-zh goes through the WordPiece path instead).
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """Byte-level BPE matching ``clip.simple_tokenizer.SimpleTokenizer``.

    Construct from HF-format ``vocab.json`` + ``merges.txt``, or the OpenAI
    ``bpe_simple_vocab_16e6.txt.gz`` merges file.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[tuple]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = vocab["<|startoftext|>"]
        self.eot = vocab["<|endoftext|>"]

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_hf_files(cls, vocab_json: str, merges_txt: str) -> "CLIPBPETokenizer":
        with open(vocab_json) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_txt) as f:
            for i, line in enumerate(f.read().split("\n")):
                # only the first line may be the '#version: ...' header; real
                # CLIP merges include '#'-initial entries (hashtag byte pairs)
                if not line or (i == 0 and line.startswith("#version")):
                    continue
                merges.append(tuple(line.split()))
        return cls(vocab, merges)

    @classmethod
    def from_openai_merges(cls, bpe_path: str) -> "CLIPBPETokenizer":
        """OpenAI ``bpe_simple_vocab_16e6.txt.gz``: merges define the vocab
        (``clip.simple_tokenizer.SimpleTokenizer.__init__``)."""
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]
        chars = list(_bytes_to_unicode().values())
        vocab_list = chars + [c + "</w>" for c in chars]
        vocab_list += ["".join(m) for m in merges]
        vocab_list += ["<|startoftext|>", "<|endoftext|>"]
        return cls({t: i for i, t in enumerate(vocab_list)}, merges)

    # -- BPE core ----------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def tokenize(self, texts: List[str], context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """``clip.tokenize`` equivalent -> [B, context_length] int32."""
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"input too long for context {context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# weight conversion (OpenAI / HF CLIP text state_dicts)
# ---------------------------------------------------------------------------

_TEXT_ROOTS = ("token_embedding.", "positional_embedding", "ln_final.", "text_projection",
               "transformer.resblocks.")


def convert_clip_text(sd: Dict, layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """OpenAI- or HF-format state dict (tensors or numpy) -> the text tower's
    state dict, float32: OpenAI's text keys, the first ``layers`` blocks
    (all when None); the vision tower's and other keys are left out."""
    if "token_embedding.weight" not in sd and any(k.startswith("text_model.") for k in sd):
        sd = _hf_text_to_openai(sd)
    return first_blocks({k: v for k, v in sd.items() if k.startswith(_TEXT_ROOTS)}, layers)


def _hf_text_to_openai(sd: Dict) -> Dict[str, torch.Tensor]:
    """Rename HF CLIPTextModelWithProjection keys to OpenAI-format keys."""
    return hf_to_openai_keys(sd, "text_model", "", {
        "text_model.embeddings.token_embedding.weight": "token_embedding.weight",
        "text_model.embeddings.position_embedding.weight": "positional_embedding",
        "text_model.final_layer_norm.weight": "ln_final.weight",
        "text_model.final_layer_norm.bias": "ln_final.bias",
    }, projection=("text_projection.weight", "text_projection"))


# ---------------------------------------------------------------------------
# the Trainer-facing frozen text_encoder factory
# ---------------------------------------------------------------------------


def infer_text_tower_kwargs(sd: Dict) -> dict:
    """Tower shape from an (OpenAI-format) text state dict: ViT-B/32 or any
    resized variant (tests use tiny towers). Heads follow the CLIP convention
    d_head=64, floor 1."""
    if "token_embedding.weight" not in sd and any(k.startswith("text_model.") for k in sd):
        sd = _hf_text_to_openai(sd)
    vocab, width = sd["token_embedding.weight"].shape
    layers = 0
    while f"transformer.resblocks.{layers}.ln_1.weight" in sd:
        layers += 1
    return dict(
        vocab_size=int(vocab),
        width=int(width),
        layers=layers,
        heads=max(1, int(width) // 64),
        context_length=int(sd["positional_embedding"].shape[0]),
        out_dim=int(sd["text_projection"].shape[1]),
    )


def build_text_encoder(text_enc_type: str, *, device: torch.device,
                       clip_weights: Optional[str] = None, vocab_json: Optional[str] = None,
                       merges_txt: Optional[str] = None
                       ) -> Callable[[List[str]], torch.Tensor]:
    """-> callable ``List[str] -> [B, dim]`` float32 on ``device`` (reference
    ``TextEncoder.__call__``). The frozen CLIP tower, its shape read from the
    weights, runs in float32 on ``device`` under ``torch.no_grad``."""
    if "CLIP" in text_enc_type:
        if not (clip_weights and vocab_json and merges_txt):
            raise ValueError("CLIP text encoder needs clip_weights + vocab_json + merges_txt")
        tokenizer = CLIPBPETokenizer.from_hf_files(vocab_json, merges_txt)
        sd = load_clip_state_dict(clip_weights)
        tower = CLIPTextTower(**infer_text_tower_kwargs(sd), device=device)
        tower.load_state_dict(convert_clip_text(sd, layers=tower.layers))
        tower.eval().requires_grad_(False)

        @torch.no_grad()
        def encode(captions: List[str]) -> torch.Tensor:
            toks = torch.from_numpy(tokenizer.tokenize(captions)).to(device)
            return tower(toks).float()

        encode.tower = tower
        return encode

    if "bert" in text_enc_type:
        # the reference's BERT CLS path (TextEncoder.py:37-52), from a
        # locally cached model only
        from transformers import AutoTokenizer, BertModel

        tk = AutoTokenizer.from_pretrained(text_enc_type, local_files_only=True)
        enc = BertModel.from_pretrained(text_enc_type, local_files_only=True).to(device).eval()

        @torch.no_grad()
        def encode_bert(captions: List[str]) -> torch.Tensor:
            batch = tk(captions, padding=True, return_tensors="pt")
            out = enc(batch["input_ids"].to(device), batch["attention_mask"].to(device))
            return out.last_hidden_state[:, 0].float()

        return encode_bert

    raise ValueError(f"unsupported text_enc_type: {text_enc_type}")

