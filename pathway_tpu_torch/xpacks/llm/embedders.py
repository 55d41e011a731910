"""Embedders (reference: python/pathway/xpacks/llm/embedders.py).

`SentenceTransformerEmbedder` is the north-star model: a batched sync UDF
whose batches run the port's encoder on the CUDA card (reference:
embedders.py:342-434). API-backed embedders (OpenAI/LiteLLM/Gemini) are
async UDFs with capacity/retry, as in the reference. Counterpart of
pathway_tpu/xpacks/llm/embedders.py; the one difference is that
`SentenceTransformerEmbedder(device=...)` places the encoder.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF, async_executor


class BaseEmbedder(UDF):
    """reference: embedders.py BaseEmbedder:67."""

    def get_embedding_dimension(self, **kwargs) -> int:
        import asyncio
        import inspect

        result = self.func(".", **kwargs)
        if inspect.isawaitable(result):
            # asyncio.run would explode if a loop is already running (e.g.
            # called from inside the aiohttp server) — run the coroutine on
            # a private loop in a helper thread instead.
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                result = asyncio.run(result)
            else:
                import concurrent.futures

                with concurrent.futures.ThreadPoolExecutor(1) as pool:
                    result = pool.submit(asyncio.run, result).result()
        return len(result)

    def __call__(self, input: Any, **kwargs) -> ColumnExpression:
        return super().__call__(input, **kwargs)


class SentenceTransformerEmbedder(BaseEmbedder):
    """Sentence encoder on the card (reference: embedders.py
    SentenceTransformerEmbedder:342 — torch SentenceTransformer with
    max_batch_size batching). `device=None` means the CUDA card;
    `device="cpu"` runs the encoder's plain PyTorch path."""

    def __init__(
        self,
        model: str = "all-MiniLM-L6-v2",
        *,
        call_kwargs: dict = {},
        device=None,
        max_batch_size: int = 1024,
        **init_kwargs,
    ):
        super().__init__(
            return_type=np.ndarray,
            deterministic=True,
            max_batch_size=max_batch_size,
        )
        from pathway_tpu_torch.models.minilm import SentenceEncoder

        self.model = model
        self.encoder = SentenceEncoder.cached(model, device=device, **init_kwargs)
        self.kwargs = dict(init_kwargs)

        def embed_batch(texts: List[str]) -> List[np.ndarray]:
            vectors = self.encoder.encode(texts)
            return list(vectors)

        # async submit/await contract for the batched-UDF runtime
        # (engine/expression_eval.py two-phase path): submit tokenizes +
        # enqueues the device encode for chunk i, so the host tokenizes
        # chunk i+1 while the card runs chunk i. encode() is literally
        # await(submit(...)), so sync and async results are bit-identical.
        def submit_batch(texts: List[str]):
            return self.encoder.encode_submit(list(texts))

        def await_batch(handle) -> List[np.ndarray]:
            return list(self.encoder.encode_await(handle))

        embed_batch.submit_batch = submit_batch
        embed_batch.await_batch = await_batch
        # static-analyzer marker (analysis PWT401/PWT402): enough shape
        # facts to predict the classic path's padding waste and check
        # mesh-axis divisibility without building a model
        embed_batch._pw_embedder = {
            "model": model,
            "max_batch_size": max_batch_size,
            "max_len": self.encoder.max_len,
            "dimension": self.encoder.dimension,
        }
        self.func = embed_batch

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.encoder.dimension

    def __call__(self, input: Any, **kwargs) -> ColumnExpression:
        return UDF.__call__(self, input)


class OpenAIEmbedder(BaseEmbedder):
    """reference: embedders.py OpenAIEmbedder:88 — async API UDF."""

    def __init__(
        self,
        model: str | None = "text-embedding-3-small",
        *,
        capacity: int | None = None,
        retry_strategy=None,
        cache_strategy=None,
        api_key: str | None = None,
        base_url: str | None = None,
        **openai_kwargs,
    ):
        super().__init__(
            return_type=np.ndarray,
            executor=async_executor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.api_key = api_key
        self.base_url = base_url or "https://api.openai.com/v1"
        self.kwargs = dict(openai_kwargs)

        async def embed(text: str, **kwargs) -> np.ndarray:
            payload = {"model": self.model, "input": text or ".", **kwargs}
            data = await _post_json(
                f"{self.base_url}/embeddings", payload, self.api_key
            )
            return np.array(data["data"][0]["embedding"], dtype=np.float32)

        self.func = embed


class LiteLLMEmbedder(BaseEmbedder):
    """reference: embedders.py LiteLLMEmbedder:251 — delegates to the
    litellm package when installed."""

    def __init__(
        self,
        model: str | None = None,
        *,
        capacity: int | None = None,
        retry_strategy=None,
        cache_strategy=None,
        **litellm_kwargs,
    ):
        super().__init__(
            return_type=np.ndarray,
            executor=async_executor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(litellm_kwargs)

        async def embed(text: str, **kwargs) -> np.ndarray:
            try:
                import litellm
            except ImportError as exc:
                raise ImportError(
                    "LiteLLMEmbedder requires the litellm package"
                ) from exc
            result = await litellm.aembedding(
                model=self.model, input=[text or "."], **{**self.kwargs, **kwargs}
            )
            return np.array(result.data[0]["embedding"], dtype=np.float32)

        self.func = embed


class GeminiEmbedder(BaseEmbedder):
    """reference: embedders.py GeminiEmbedder:446."""

    def __init__(
        self,
        model: str | None = "models/embedding-001",
        *,
        capacity: int | None = None,
        retry_strategy=None,
        cache_strategy=None,
        api_key: str | None = None,
        **gemini_kwargs,
    ):
        super().__init__(
            return_type=np.ndarray,
            executor=async_executor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.api_key = api_key
        self.kwargs = dict(gemini_kwargs)

        async def embed(text: str, **kwargs) -> np.ndarray:
            url = (
                "https://generativelanguage.googleapis.com/v1beta/"
                f"{self.model}:embedContent?key={self.api_key}"
            )
            payload = {"content": {"parts": [{"text": text or "."}]}}
            data = await _post_json(url, payload, None)
            return np.array(
                data["embedding"]["values"], dtype=np.float32
            )

        self.func = embed


async def _post_json(url: str, payload: dict, bearer: str | None) -> dict:
    import aiohttp

    headers = {"Content-Type": "application/json"}
    if bearer:
        headers["Authorization"] = f"Bearer {bearer}"
    async with aiohttp.ClientSession() as session:
        async with session.post(url, json=payload, headers=headers) as resp:
            resp.raise_for_status()
            return await resp.json()
