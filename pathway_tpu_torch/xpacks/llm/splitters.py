"""Text splitters (reference: python/pathway/xpacks/llm/splitters.py).

Splitters are UDFs returning `list[tuple[str, dict]]` — (chunk, metadata)
pairs, exactly the reference contract (splitters.py BaseSplitter:21)."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF

_SEPARATORS = ["\n\n", "\n", ". ", " ", ""]


def _meta(value: Any) -> dict:
    if isinstance(value, Json):
        value = value.value
    return dict(value or {})


class BaseSplitter(UDF):
    """reference: splitters.py BaseSplitter:21."""

    def __init__(self, **kwargs):
        super().__init__(return_type=list, deterministic=True, **kwargs)

    def __call__(self, text, metadata=None, **kwargs) -> ColumnExpression:
        if metadata is None:
            metadata = Json({})
        return super().__call__(text, metadata, **kwargs)


class NullSplitter(BaseSplitter):
    """reference: splitters.py NullSplitter:161."""

    def __init__(self):
        super().__init__(max_batch_size=65536)

        def split(texts: list, metadatas: list) -> list:
            return [
                [(text, _meta(metadata))]
                for text, metadata in zip(texts, metadatas)
            ]

        self.func = split


class TokenCountSplitter(BaseSplitter):
    """Split into chunks of min..max tokens (reference: splitters.py
    TokenCountSplitter:177 — tiktoken there, the in-tree tokenizer here)."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
    ):
        super().__init__()
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        from pathway_tpu_torch.models.tokenizer import HashTokenizer

        tokenizer = HashTokenizer()

        def split(text: str, metadata) -> list:
            meta = _meta(metadata)
            words = text.split()
            if not words:
                return []
            chunks: List[Tuple[str, dict]] = []
            current: List[str] = []
            count = 0
            for word in words:
                n = max(1, tokenizer.count_tokens(word))
                if count + n > self.max_tokens and count >= self.min_tokens:
                    chunks.append((" ".join(current), dict(meta)))
                    current, count = [], 0
                current.append(word)
                count += n
            if current:
                if chunks and count < self.min_tokens:
                    last_text, last_meta = chunks[-1]
                    chunks[-1] = (last_text + " " + " ".join(current), last_meta)
                else:
                    chunks.append((" ".join(current), dict(meta)))
            return chunks

        self.func = split


class RecursiveSplitter(BaseSplitter):
    """Character/token recursive splitting with overlap (reference:
    splitters.py RecursiveSplitter:88 — langchain there; a self-contained
    recursive splitter here)."""

    def __init__(
        self,
        chunk_size: int = 500,
        chunk_overlap: int = 0,
        separators: List[str] | None = None,
        encoding_name: str | None = None,
        model_name: str | None = None,
    ):
        super().__init__()
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or _SEPARATORS

        def split_recursive(text: str, separators: List[str]) -> List[str]:
            if len(text) <= self.chunk_size:
                return [text] if text.strip() else []
            if not separators:
                return [
                    text[i : i + self.chunk_size]
                    for i in range(0, len(text), self.chunk_size)
                ]
            sep, rest = separators[0], separators[1:]
            if sep == "":
                return [
                    text[i : i + self.chunk_size]
                    for i in range(0, len(text), self.chunk_size)
                ]
            parts = text.split(sep)
            chunks: List[str] = []
            current = ""
            for part in parts:
                candidate = current + sep + part if current else part
                if len(candidate) <= self.chunk_size:
                    current = candidate
                else:
                    if current.strip():
                        chunks.append(current)
                    if len(part) > self.chunk_size:
                        chunks.extend(split_recursive(part, rest))
                        current = ""
                    else:
                        current = part
            if current.strip():
                chunks.append(current)
            return chunks

        def split(text: str, metadata) -> list:
            meta = _meta(metadata)
            chunks = split_recursive(text, self.separators)
            # overlap applies ONCE over the final chunk list (inside the
            # recursion it compounds tails across levels)
            if self.chunk_overlap > 0 and len(chunks) > 1:
                chunks = [chunks[0]] + [
                    prev[-self.chunk_overlap :] + cur
                    for prev, cur in zip(chunks, chunks[1:])
                ]
            return [(chunk, dict(meta)) for chunk in chunks]

        self.func = split
