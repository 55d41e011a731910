"""pw.universes — key-set promises (reference:
python/pathway/internals/universes.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals.universe import solver


def promise_are_equal(*tables) -> None:
    for a, b in zip(tables, tables[1:]):
        solver.register_equal(a._universe, b._universe)


def promise_is_subset_of(subset, superset) -> None:
    solver.register_subset(subset._universe, superset._universe)


def promise_are_pairwise_disjoint(*tables) -> None:
    for i, a in enumerate(tables):
        for b in tables[i + 1:]:
            solver.register_disjoint(a._universe, b._universe)
