"""The hashing tokenizer's rule, frozen.

Copied from pathway_tpu_torch/models/tokenizer.py (`HashTokenizer`:
lowercase, words and single punctuation marks, crc32 ids above four
reserved ids, [CLS] ... [SEP], the first `max_len` kept; `decode` renders
ids at or above the reserved ones as `tok<id>`). The benchmark counts
tokens with it and the reference tokenizes with it; it imports nothing
of the program.
"""

from __future__ import annotations

import re
import zlib

_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")
CLS_ID, SEP_ID, RESERVED = 1, 2, 4


def words(text: str) -> list:
    return _WORD_RE.findall(text.lower())


def encode(text: str, vocab_size: int, max_len: int | None = None) -> list:
    ids = [CLS_ID] + [RESERVED + zlib.crc32(w.encode()) % (vocab_size - RESERVED)
                      for w in words(text)] + [SEP_ID]
    return ids if max_len is None else ids[:max_len]


def count(text: str, max_len: int | None = None) -> int:
    """Tokens of `text` after [CLS] / [SEP] and the cut at max_len."""
    n = len(words(text)) + 2
    return n if max_len is None else min(n, max_len)


def decode(ids) -> str:
    return " ".join(f"tok{i}" for i in ids if i >= RESERVED)
