"""The one traffic generator: chunk texts and questions from a seed.

Words are drawn Zipf-distributed from a vocabulary of made-up lowercase
words that the seed makes. Chunk lengths follow what
`TokenCountSplitter(min_tokens=50, max_tokens=500)` emits: most chunks
full (400-500 tokens), the rest a document's tail (50-400). Every file of
chunks holds the same multiset of lengths, evenly spaced over those
ranges, in an order the seed draws: seeds change the words and the order,
never the amount of work. Each chunk starts with its own id word
(`c<n>`), so no two chunks are alike and a chunk is found by its id.

The lengths count words; the hashing tokenizer makes one token a word
and adds two, and the embedder keeps the first 256.

Imports numpy only, so the writer process starts fast.
"""

from __future__ import annotations

import hashlib

import numpy as np

_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any size)."""
    digest = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _vocabulary(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    words: set = set()
    out = []
    while len(out) < n:
        lengths = rng.integers(lo, hi + 1, size=2 * n)
        letters = rng.integers(0, 26, size=int(lengths.sum()))
        at = 0
        for ln in lengths:
            w = "".join(_LETTERS[letters[at : at + ln]])
            at += ln
            # an id word (c<digits>) is never a vocabulary word: letters only
            if w not in words:
                words.add(w)
                out.append(w)
                if len(out) == n:
                    break
    return np.array(out, dtype=object)


def length_multiset(mix: dict, n: int) -> np.ndarray:
    """The word counts of `n` chunks: `full_share` of them spread evenly
    over `full_words`, the rest over `tail_words`."""
    n_full = int(round(mix["full_share"] * n))
    full = np.linspace(*mix["full_words"], n_full) if n_full else np.zeros(0)
    tail = np.linspace(*mix["tail_words"], n - n_full) if n > n_full else np.zeros(0)
    return np.concatenate([full, tail]).round().astype(np.int64)


class TextGen:
    """Texts of one traffic mix under one seed."""

    def __init__(self, seed: int, traffic: dict):
        self.seed = int(seed)
        self.mix = traffic["chunks"]
        self.per_file = int(traffic["chunks_per_file"])
        rng = np.random.default_rng(subseed(seed, "vocabulary"))
        self.words = _vocabulary(rng, int(traffic["vocab_words"]), *traffic["word_letters"])
        ranks = np.arange(1, len(self.words) + 1, dtype=np.float64)
        weights = ranks ** -float(traffic["zipf_s"])
        self.cdf = np.cumsum(weights) / weights.sum()
        self._lengths = length_multiset(self.mix, self.per_file)

    def draw_words(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random(n), side="right")
        return self.words[np.minimum(idx, len(self.words) - 1)]

    def file_lengths(self, f: int) -> np.ndarray:
        """Word counts (id word included) of file f's chunks, in order."""
        rng = np.random.default_rng(subseed(self.seed, "lengths", f))
        return self._lengths[rng.permutation(self.per_file)]

    def file_chunks(self, f: int) -> list:
        """The texts of file f: chunks f * per_file ... in order."""
        lengths = self.file_lengths(f)
        rng = np.random.default_rng(subseed(self.seed, "words", f))
        body = self.draw_words(rng, int((lengths - 1).sum())).tolist()
        out, at = [], 0
        base = f * self.per_file
        for i, ln in enumerate(lengths.tolist()):
            out.append(" ".join([f"c{base + i}"] + body[at : at + ln - 1]))
            at += ln - 1
        return out

    def questions(self, stream: int, n: int, lo: int, hi: int) -> list:
        """`n` questions of lo-hi words for client `stream`; every stream
        gets the same multiset of lengths."""
        rng = np.random.default_rng(subseed(self.seed, "questions", stream))
        lengths = np.linspace(lo, hi, n).round().astype(np.int64)[rng.permutation(n)]
        words = self.draw_words(rng, int(lengths.sum())).tolist()
        out, at = [], 0
        for ln in lengths.tolist():
            out.append(" ".join(words[at : at + ln]) + " ?")
            at += ln
        return out


def chunk_id(text: str) -> int:
    """The chunk number of a chunk text (its first word, c<n>)."""
    head = text.split(" ", 1)[0]
    if not head.startswith("c") or not head[1:].isdigit():
        raise ValueError(f"not a chunk of this generator: {text[:40]!r}")
    return int(head[1:])


def json_line(text: str) -> str:
    """One jsonlines row {"data": text}; the texts need no escaping."""
    return '{"data": "' + text + '"}\n'
