"""The Private-RAG prompt, frozen.

Copied from pathway_tpu_torch/xpacks/llm/prompts.py (`prompt_qa`, its
defaults: the docs' texts joined by blank lines) and llms.py
(`prompt_chat_single_qa` then `_messages_to_prompt`: one user message
rendered as "user: <content>").
"""

from __future__ import annotations

NOT_FOUND = "No information found."


def qa(question: str, doc_texts) -> str:
    context = "\n\n".join(str(t) for t in doc_texts)
    return (
        "Please provide an answer based solely on the provided sources. "
        "When referencing information from a source, cite it. "
        f"If none of the sources are helpful, respond with {NOT_FOUND!r}.\n"
        f"Context: {context}\nQuestion: {question}\nAnswer:"
    )


def chat(text: str) -> str:
    return f"user: {text}"


def served_prompt(question: str, doc_texts) -> str:
    """The text the chat model is asked to continue for one answer."""
    return chat(qa(question, doc_texts))
