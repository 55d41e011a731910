"""Extension packs (reference: python/pathway/xpacks).

The port has `llm` so far; `connectors` is still to come (ROADMAP, Queue 1,
item 1.4)."""

from pathway_tpu_torch.xpacks import llm

__all__ = ["llm"]
