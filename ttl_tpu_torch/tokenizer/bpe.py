"""CLIP byte-pair-encoding tokenizer.

A from-scratch implementation of the public CLIP BPE scheme (byte-level BPE
with word-end ``</w>`` markers, lowercased input, GPT-2-style byte escaping)
over the merge table asset in ``ttl_tpu_torch/data/assets/clip_bpe_merges.txt.gz`` (the port's own copy of
``ttl_tpu/tokenizer/bpe.py`` and of the merges file).
Functional equivalent of the reference's bundled tokenizer
(reference: clip/simple_tokenizer.py, clip/clip.py:196-232); runs once per
dataset to build prompt token tables, never in the device hot path.

The reference cleans text with ftfy; this environment has no ftfy, so the
cleaner falls back to html-unescape + NFC normalization, which is identity on
the ASCII classname/prompt tables TTL uses.
"""
from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from pathlib import Path
from typing import Dict, List, Tuple

import regex as re

try:  # ftfy when available, to mirror the reference bit-for-bit; resolved
    # once here, since a failed import search on every call costs more than
    # the rest of the tokenizer
    import ftfy
except ImportError:
    ftfy = None

_ASSET = Path(__file__).resolve().parent.parent / "data" / "assets" / \
    "clip_bpe_merges.txt.gz"

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """Invertible byte -> printable unicode char map (GPT-2 scheme): the
    printable latin ranges map to themselves, everything else is shifted into
    the 256+ private range so no token string contains control bytes."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    # Insertion order matters: printable ranges first, then shifted bytes -
    # iteration order of this dict defines the vocab id layout.
    mapping = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    if ftfy is not None:
        text = ftfy.fix_text(text)
    else:
        text = unicodedata.normalize("NFC", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class ClipTokenizer:
    """Byte-level BPE with </w> word terminals and CLIP's 49408-entry vocab."""

    _PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        re.IGNORECASE,
    )

    def __init__(self, merges_path: str | Path = _ASSET):
        with gzip.open(merges_path, "rt", encoding="utf-8") as f:
            merge_lines = [l for l in f.read().split("\n") if l]
        self._merges: List[Tuple[str, str]] = [
            tuple(l.split()) for l in merge_lines]
        self._rank = {m: i for i, m in enumerate(self._merges)}

        byte_chars = list(_byte_unicode_table().values())
        vocab = byte_chars + [c + "</w>" for c in byte_chars]
        vocab += ["".join(m) for m in self._merges]
        vocab += [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in
                                        self.encoder.items()}
        self._byte_enc = _byte_unicode_table()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT]

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self._rank.get(p, float("inf")))
            if best not in self._rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1
                        and (word[i], word[i + 1]) == best):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no SOT/EOT framing)."""
        ids: List[int] = []
        for tok in self._PATTERN.findall(_clean(text).lower()):
            tok_bytes = "".join(self._byte_enc[b]
                                for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(tok_bytes))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytes(self._byte_dec[c] for c in text
                    if c in self._byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH,
             truncate: bool = False):
    """Batch-tokenize with SOT/EOT framing and zero padding.

    Mirrors the reference surface (clip/clip.py:196-232): returns an int32
    [N, context_length] array; raises on overflow unless ``truncate``.
    """
    import numpy as np

    if isinstance(texts, str):
        texts = [texts]
    tk = default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tk.sot_id] + tk.encode(text) + [tk.eot_id]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = tk.eot_id
            else:
                raise RuntimeError(
                    f"Input {texts[i]!r} is too long for context length "
                    f"{context_length}")
        out[i, : len(ids)] = ids
    return out
