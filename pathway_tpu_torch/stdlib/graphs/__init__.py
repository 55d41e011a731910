"""pw.graphs — graph algorithms (reference: python/pathway/stdlib/graphs/:
bellman_ford/impl.py, pagerank/impl.py, louvain_communities/impl.py).
All are fixed-point computations over edge tables via pw.iterate."""

from pathway_tpu_torch.stdlib.graphs.common import (
    Clustering,
    Edge,
    Graph,
    Vertex,
    Weight,
    WeightedGraph,
)
from pathway_tpu_torch.stdlib.graphs.pagerank import pagerank
from pathway_tpu_torch.stdlib.graphs.bellman_ford import bellman_ford
from pathway_tpu_torch.stdlib.graphs.louvain import _louvain_level, louvain_communities

__all__ = [
    "Clustering",
    "Edge",
    "Graph",
    "Vertex",
    "Weight",
    "WeightedGraph",
    "pagerank",
    "bellman_ford",
    "louvain_communities",
]
