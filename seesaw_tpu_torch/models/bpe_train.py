"""Deterministic byte-level BPE training: build CLIP-format vocab artifacts.

Produces `vocab.json` + `merges.txt` in the exact file format HF CLIP
checkpoints ship (and `transformers.CLIPTokenizer` reads): base vocabulary of
all 256 byte-units plus their word-final `</w>` variants, merge rules learned
greedily by pair frequency (ties broken lexicographically, so the build is
fully deterministic), specials appended last.

This exists so the full real-CLIP text path (BpeTokenizer == HF
CLIPTokenizer, enforced by tests/test_tokenizer_parity.py) can be exercised
and demoed without network access; with a real checkpoint one uses its own
vocab.json/merges.txt instead.

The port's own copy of `seesaw_tpu/models/bpe_train.py`, over the port's
`models.tokenizer`.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Tuple

from .tokenizer import EOT, SOT, _WORD_RE, _basic_clean, _bytes_to_unicode


def _words(corpus: Iterable[str]) -> Counter:
    byte_encoder = _bytes_to_unicode()
    counts: Counter = Counter()
    for text in corpus:
        for tok in _WORD_RE.findall(_basic_clean(text)):
            sym = "".join(byte_encoder[b] for b in tok.encode("utf-8"))
            counts[sym] += 1
    return counts


def train_bpe(corpus: Iterable[str], n_merges: int) -> List[Tuple[str, str]]:
    """Greedy pair-frequency BPE over the corpus' words; deterministic."""
    word_counts = _words(corpus)
    words = {
        w: tuple(w[:-1]) + (w[-1] + "</w>",) for w in word_counts
    }
    merges: List[Tuple[str, str]] = []
    for _ in range(n_merges):
        pair_counts: Counter = Counter()
        for w, sym in words.items():
            c = word_counts[w]
            for i in range(len(sym) - 1):
                pair_counts[(sym[i], sym[i + 1])] += c
        if not pair_counts:
            break
        best_count = max(pair_counts.values())
        best = min(p for p, c in pair_counts.items() if c == best_count)
        if best_count < 2:
            break
        merges.append(best)
        first, second = best
        new_words = {}
        for w, sym in words.items():
            out: List[str] = []
            i = 0
            while i < len(sym):
                if i < len(sym) - 1 and sym[i] == first and sym[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            new_words[w] = tuple(out)
        words = new_words
    return merges


def build_vocab(merges: List[Tuple[str, str]]) -> dict:
    """CLIP vocab layout: byte units, byte+'</w>' units, merged symbols in
    merge order, then SOT/EOT."""
    byte_units = list(_bytes_to_unicode().values())
    tokens = byte_units + [u + "</w>" for u in byte_units]
    tokens += [a + b for a, b in merges]
    tokens += [SOT, EOT]
    return {t: i for i, t in enumerate(tokens)}


def write_artifacts(out_dir: str | Path, corpus: Iterable[str], n_merges: int = 512):
    """Train and write vocab.json + merges.txt (HF CLIP checkpoint format)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    merges = train_bpe(corpus, n_merges)
    vocab = build_vocab(merges)
    (out / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (out / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8",
    )
    return out / "vocab.json", out / "merges.txt"
