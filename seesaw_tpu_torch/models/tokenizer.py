"""CLIP text tokenization (framework-free).

The port's own copy of `seesaw_tpu/models/tokenizer.py`, unchanged in
behaviour; `tests/test_torch_tokenizer.py` holds the two to the same ids.

`BpeTokenizer` reproduces `transformers.CLIPTokenizer` token-for-token in
its ftfy-less path: BasicTokenizer-style cleanup (control-char strip, CJK
padding, NFC, lowercase, no accent stripping, no punctuation splitting), the
CLIP word regex, byte-level BPE with word-final `</w>`, and unk fallback to
EOT. It loads `vocab.json` + `merges.txt`, the artifacts shipped with every
HF CLIP checkpoint.

With no vocab files available, `HashTokenizer` provides a deterministic
word-hash fallback for synthetic benchmarks.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List

import numpy as np

try:  # the CLIP word pattern needs \p{L}/\p{N}; `regex` ships with transformers
    import regex as _re

    _WORD_RE = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is a baked-in dependency here
    import re as _re

    _WORD_RE = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        _re.IGNORECASE,
    )

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def _basic_clean(text: str) -> str:
    """BasicTokenizer(strip_accents=False, do_split_on_punc=False) semantics:
    drop control chars, whitespace -> ' ', pad CJK chars, NFC-normalize,
    lowercase per whitespace token, re-join single-spaced."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            chars.extend((" ", ch, " "))
        elif _is_whitespace(ch):
            chars.append(" ")
        else:
            chars.append(ch)
    text = unicodedata.normalize("NFC", "".join(chars))
    return " ".join(tok.lower() for tok in text.split())


@lru_cache()
def _bytes_to_unicode():
    """GPT-2 byte<->unicode table (standard construction)."""
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


class BpeTokenizer:
    def __init__(self, vocab_path: str, merges_path: str, context_length: int = 77):
        self.context_length = context_length
        vocab_path, merges_path = Path(vocab_path), Path(merges_path)
        self.encoder = json.loads(vocab_path.read_text(encoding="utf-8"))
        opener = gzip.open if merges_path.suffix == ".gz" else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            # first line is the "#version:" header; cap matches HF's slice
            lines = f.read().strip().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(l.split()) for l in lines]
        self.bpe_ranks = {m: i for i, m in enumerate(merges) if len(m) == 2}
        self.byte_encoder = _bytes_to_unicode()
        self.sot = self.encoder[SOT]
        self.eot = self.encoder[EOT]
        self._cache: dict = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Token ids without specials/padding (HF `_tokenize` + id lookup);
        unknown subwords map to EOT, HF's unk convention."""
        ids: List[int] = []
        for tok in _WORD_RE.findall(_basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder.get(t, self.eot) for t in self._bpe(tok))
        return ids

    def encode(self, text: str) -> np.ndarray:
        """SOT + tokens + EOT, truncated to context_length, zero-padded.
        (Padding after EOT is inert: the text tower is causal and pools at
        the first EOT position, so zero- vs EOT-padding are equivalent.)"""
        ids = [self.sot] + self.tokenize(text)
        ids = ids[: self.context_length - 1]
        ids.append(self.eot)
        out = np.zeros(self.context_length, dtype=np.int32)
        out[: len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic fallback: each word hashes to a bucket id. SOT=vocab-2
    is at position 0, EOT=vocab-1 terminates (argmax pooling finds it, as
    EOT is the largest id — same convention as CLIP)."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> np.ndarray:
        ids = [self.sot]
        for w in _basic_clean(text).split():
            h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
            ids.append(h % (self.vocab_size - 2))
        ids = ids[: self.context_length - 1]
        ids.append(self.eot)
        out = np.zeros(self.context_length, dtype=np.int32)
        out[: len(ids)] = ids
        return out


def default_tokenizer(context_length: int, vocab_size: int, vocab_dir=None):
    """BPE if vocab files are discoverable, else the hash fallback."""
    bases = [Path(vocab_dir)] if vocab_dir else []
    bases += [Path(__file__).parent / "vocab", Path.home() / ".cache" / "clip"]
    for base in bases:
        v, m = base / "vocab.json", base / "merges.txt"
        if v.exists() and m.exists():
            return BpeTokenizer(str(v), str(m), context_length)
    return HashTokenizer(context_length, vocab_size)
