"""Universes — key-set identities of tables (reference:
python/pathway/internals/universe.py + universe_solver.py).

A lightweight union-find + relation registry replaces the reference's solver:
ops register equality / subset facts as the graph is built, and same-universe
preconditions (update_cells, with_universe_of, ...) are validated against it.
Runtime key checks in the engine back these static promises up.
"""

from __future__ import annotations

import itertools
from typing import Dict, Set, Tuple

_ids = itertools.count()


class Universe:
    __slots__ = ("id", "multiset")

    def __init__(self, multiset: bool = False):
        self.id = next(_ids)
        # event-stream universes (to_stream outputs) are multisets: a key
        # may recur across batches; every derived universe inherits this so
        # filter/select/copy chains materialize without the unique-key check
        self.multiset = multiset

    def __repr__(self):
        return f"U{self.id}"

    def subset(self) -> "Universe":
        u = Universe(multiset=self.multiset)
        solver.register_subset(u, self)
        return u

    def superset(self) -> "Universe":
        u = Universe(multiset=self.multiset)
        solver.register_subset(self, u)
        return u


class UniverseSolver:
    def __init__(self):
        self._parent: Dict[Universe, Universe] = {}
        self._subsets: Set[Tuple[int, int]] = set()
        # disjointness facts keep the ORIGINAL universe objects: roots
        # are recomputed at query time, so a later register_equal merge
        # cannot orphan a fact registered against a pre-merge root
        self._disjoint_facts: list = []

    def _find(self, u: Universe) -> Universe:
        while self._parent.get(u, u) is not u:
            self._parent[u] = self._parent.get(self._parent[u], self._parent[u])
            u = self._parent[u]
        return u

    def register_equal(self, a: Universe, b: Universe) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra is not rb:
            self._parent[ra] = rb

    def register_subset(self, sub: Universe, sup: Universe) -> None:
        self._subsets.add((self._find(sub).id, self._find(sup).id))

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self._find(a) is self._find(b)

    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        ra, rb = self._find(sub), self._find(sup)
        if ra is rb:
            return True
        # BFS through registered subset facts
        seen = {ra.id}
        frontier = [ra.id]
        while frontier:
            cur = frontier.pop()
            for s, p in self._subsets:
                if s == cur and p not in seen:
                    if p == rb.id:
                        return True
                    seen.add(p)
                    frontier.append(p)
        return False

    def register_disjoint(self, a: Universe, b: Universe) -> None:
        self._disjoint_facts.append((a, b))

    def _supersets(self, u: Universe) -> Set[int]:
        """Root ids of u and every registered superset (transitively)."""
        root = self._find(u).id
        seen = {root}
        frontier = [root]
        while frontier:
            cur = frontier.pop()
            for s, p in self._subsets:
                if s == cur and p not in seen:
                    seen.add(p)
                    frontier.append(p)
        return seen

    def query_are_disjoint(self, a: Universe, b: Universe) -> bool:
        """True when some registered superset of `a` is known disjoint
        from some registered superset of `b` (subsets of disjoint sets
        are disjoint). Fact roots are resolved NOW, surviving merges
        registered after the fact."""
        sup_a = self._supersets(a)
        sup_b = self._supersets(b)
        for x, y in self._disjoint_facts:
            rx, ry = self._find(x).id, self._find(y).id
            if (rx in sup_a and ry in sup_b) or (
                ry in sup_a and rx in sup_b
            ):
                return True
        return False

    def get_intersection(self, *universes: Universe) -> Universe:
        u = Universe(multiset=any(x.multiset for x in universes))
        for x in universes:
            self.register_subset(u, x)
        return u

    def get_union(self, *universes: Universe) -> Universe:
        u = Universe(multiset=any(x.multiset for x in universes))
        for x in universes:
            self.register_subset(x, u)
        return u


solver = UniverseSolver()
