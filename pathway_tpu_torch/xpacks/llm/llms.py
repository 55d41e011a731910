"""Chat wrappers (reference: python/pathway/xpacks/llm/llms.py).

`HFPipelineChat` is the local-generation path: it runs the port's
KV-cached decoder on the card (reference: llms.py:456 — torch transformers
pipeline, batch 32). API chats (OpenAI/LiteLLM/Cohere) are async UDFs with
retry/cache. Counterpart of pathway_tpu/xpacks/llm/llms.py; the one
difference is that `HFPipelineChat(device=...)` places the decoder.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional

from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import apply_with_type
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF, async_executor


def _messages_to_prompt(messages: Any) -> str:
    if isinstance(messages, Json):
        messages = messages.value
    if isinstance(messages, str):
        return messages
    if isinstance(messages, (list, tuple)):
        parts = []
        for m in messages:
            if isinstance(m, Json):
                m = m.value
            if isinstance(m, dict):
                parts.append(f"{m.get('role', 'user')}: {m.get('content', '')}")
            else:
                parts.append(str(m))
        return "\n".join(parts)
    return str(messages)


class BaseChat(UDF):
    """reference: llms.py BaseChat:43."""

    model: str | None = None

    def get_model_name(self) -> str | None:
        return self.model

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True

    def __call__(self, messages, **kwargs) -> ColumnExpression:
        return super().__call__(messages, **kwargs)


class OpenAIChat(BaseChat):
    """reference: llms.py OpenAIChat:95."""

    def __init__(
        self,
        model: str | None = "gpt-4o-mini",
        *,
        capacity: int | None = None,
        retry_strategy=None,
        cache_strategy=None,
        api_key: str | None = None,
        base_url: str | None = None,
        **openai_kwargs,
    ):
        super().__init__(
            return_type=Optional[str],
            executor=async_executor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.api_key = api_key
        self.base_url = base_url or "https://api.openai.com/v1"
        self.kwargs = dict(openai_kwargs)

        async def chat(messages, **kwargs) -> str | None:
            from pathway_tpu_torch.xpacks.llm.embedders import _post_json

            msgs = messages.value if isinstance(messages, Json) else messages
            if isinstance(msgs, str):
                msgs = [{"role": "user", "content": msgs}]
            payload = {
                "model": kwargs.pop("model", self.model),
                "messages": msgs,
                **{**self.kwargs, **kwargs},
            }
            data = await _post_json(
                f"{self.base_url}/chat/completions", payload, self.api_key
            )
            return data["choices"][0]["message"]["content"]

        self.func = chat


class LiteLLMChat(BaseChat):
    """reference: llms.py LiteLLMChat:324."""

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
            return_type=Optional[str],
            executor=async_executor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(litellm_kwargs)

        async def chat(messages, **kwargs) -> str | None:
            try:
                import litellm
            except ImportError as exc:
                raise ImportError(
                    "LiteLLMChat requires the litellm package"
                ) from exc
            msgs = messages.value if isinstance(messages, Json) else messages
            if isinstance(msgs, str):
                msgs = [{"role": "user", "content": msgs}]
            response = await litellm.acompletion(
                model=kwargs.pop("model", self.model),
                messages=msgs,
                **{**self.kwargs, **kwargs},
            )
            return response.choices[0].message.content

        self.func = chat


class CohereChat(BaseChat):
    """reference: llms.py CohereChat:621."""

    def __init__(
        self,
        model: str | None = "command",
        *,
        capacity: int | None = None,
        retry_strategy=None,
        cache_strategy=None,
        api_key: str | None = None,
        **cohere_kwargs,
    ):
        super().__init__(
            return_type=Optional[str],
            executor=async_executor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.api_key = api_key
        self.kwargs = dict(cohere_kwargs)

        async def chat(messages, **kwargs) -> str | None:
            from pathway_tpu_torch.xpacks.llm.embedders import _post_json

            prompt = _messages_to_prompt(messages)
            payload = {
                "model": self.model,
                "message": prompt,
                **{**self.kwargs, **kwargs},
            }
            data = await _post_json(
                "https://api.cohere.ai/v1/chat", payload, self.api_key
            )
            return data.get("text")

        self.func = chat


class HFPipelineChat(BaseChat):
    """Local generation on the card via the port's decoder (reference:
    llms.py HFPipelineChat:456 — name kept for parity; 'HF pipeline' here
    means the in-tree decoder, Mistral-class geometry for the Private-RAG
    config). `device=None` means the CUDA card; `device="cpu"` runs the
    decoder's plain PyTorch path. A `generator=` is used as given, on its
    own device."""

    def __init__(
        self,
        model: str | None = "tiny-decoder",
        *,
        call_kwargs: dict = {},
        device=None,
        max_batch_size: int = 32,
        max_new_tokens: int = 32,
        generator=None,
        **pipeline_kwargs,
    ):
        super().__init__(
            return_type=Optional[str],
            deterministic=True,
            max_batch_size=max_batch_size,
        )
        self.model = model
        self.max_new_tokens = call_kwargs.get("max_new_tokens", max_new_tokens)
        if generator is not None:
            self.generator = generator
        else:
            from pathway_tpu_torch.models.decoder_lm import ChatModel

            self.generator = ChatModel.cached(model or "tiny-decoder", device=device)

        def chat_batch(messages_batch: List[Any]) -> List[str | None]:
            prompts = [_messages_to_prompt(m) for m in messages_batch]
            return list(
                self.generator.generate(
                    prompts, max_new_tokens=self.max_new_tokens
                )
            )

        self.func = chat_batch

    def crop_to_max_length(self, input_string: str, max_prompt_length: int = 500) -> str:
        words = input_string.split()
        if len(words) > max_prompt_length:
            words = words[-max_prompt_length:]
        return " ".join(words)


def prompt_chat_single_qa(question) -> ColumnExpression:
    """Wrap a question column into a single-message chat (reference:
    llms.py prompt_chat_single_qa:761)."""
    return apply_with_type(
        lambda q: Json([{"role": "user", "content": q}]), Json, question
    )
