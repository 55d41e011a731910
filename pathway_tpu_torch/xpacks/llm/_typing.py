"""Shared typing aliases for the LLM xpack (reference:
xpacks/llm/_typing.py)."""

from __future__ import annotations

from typing import Callable, Iterable, TypeAlias, Union

from pathway_tpu_torch.internals.udfs import UDF

Doc: TypeAlias = "dict[str, str | dict]"

DocTransformerCallable: TypeAlias = Union[
    Callable[[Iterable["Doc"]], Iterable["Doc"]],
    Callable[[Iterable["Doc"], float], Iterable["Doc"]],
]

DocTransformer: TypeAlias = Union[UDF, DocTransformerCallable]
