"""CLIP's byte-level BPE tokenizer, for the reference's class prompts.

A frozen copy of the public CLIP scheme (lowercased text, GPT-2 byte
escaping, `</w>` word ends, the 49408-entry vocabulary built from
`clip_bpe_merges.txt.gz` beside this file), so that the reference tokenizes
its prompts itself and reads nothing of the program under test.
"""
from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import regex as re

MERGES = Path(__file__).resolve().parent / "clip_bpe_merges.txt.gz"
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT = 77
_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", re.IGNORECASE)


def _byte_table() -> Dict[int, str]:
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


class Tokenizer:
    def __init__(self, merges: Path = MERGES):
        with gzip.open(merges, "rt", encoding="utf-8") as f:
            pairs = [tuple(line.split()) for line in f.read().split("\n")
                     if line]
        self.rank = {p: i for i, p in enumerate(pairs)}
        chars = list(_byte_table().values())
        vocab = chars + [c + "</w>" for c in chars]
        vocab += ["".join(p) for p in pairs] + [SOT, EOT]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.byte_enc = _byte_table()

    def _bpe(self, token: str) -> List[str]:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> List[int]:
        text = unicodedata.normalize("NFC", html.unescape(html.unescape(
            text)))
        text = re.sub(r"\s+", " ", text).strip().lower()
        out: List[int] = []
        for tok in _PATTERN.findall(text):
            escaped = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            out.extend(self.ids[p] for p in self._bpe(escaped))
        return out


@functools.lru_cache(maxsize=1)
def tokenizer() -> Tokenizer:
    return Tokenizer()


def prompt_table(classnames: Sequence[str],
                 template: str = "a photo of a {}.") -> np.ndarray:
    """[C, 77] int64 token ids of one prompt per class, SOT ... EOT, zero
    padded; underscores in a class name become spaces."""
    tk = tokenizer()
    out = np.zeros((len(classnames), CONTEXT), np.int64)
    for i, name in enumerate(classnames):
        ids = ([tk.ids[SOT]] + tk.encode(template.format(
            name.replace("_", " "))) + [tk.ids[EOT]])
        if len(ids) > CONTEXT:
            raise ValueError(f"prompt for {name!r} exceeds {CONTEXT} tokens")
        out[i, :len(ids)] = ids
    return out
