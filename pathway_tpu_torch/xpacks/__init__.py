"""Extension packs (reference: python/pathway/xpacks)."""

from pathway_tpu_torch.xpacks import connectors, llm

__all__ = ["connectors", "llm"]
