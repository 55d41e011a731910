"""Graph data model (reference: stdlib/graphs/common.py)."""

from __future__ import annotations

from pathway_tpu_torch.internals.schema import Schema


class Vertex(Schema):
    pass


class Edge(Schema):
    u: object  # Pointer to source vertex
    v: object  # Pointer to target vertex


class Graph:
    def __init__(self, V, E):
        self.V = V
        self.E = E


class Weight(Schema):
    weight: float


class Clustering(Schema):
    c: object  # Pointer to the cluster representative


class WeightedGraph(Graph):
    """Graph with weighted edges (reference: stdlib/graphs/graph.py
    WeightedGraph). `WE` holds u, v, weight."""

    def __init__(self, V, E, WE=None):
        super().__init__(V, E)
        self.WE = WE if WE is not None else E

    @classmethod
    def from_vertices_and_weighted_edges(cls, V, WE) -> "WeightedGraph":
        return cls(V, WE, WE)
