"""Standard library (reference: python/pathway/stdlib).

The port has `indexing` so far; temporal, ordered, stateful, statistical,
ml, graphs, viz and utils are still to come (ROADMAP, Queue 1, item 1.4)."""

from pathway_tpu_torch.stdlib import indexing

__all__ = ["indexing"]
