"""PageRank (reference: python/pathway/stdlib/graphs/pagerank/impl.py).

Edges table has pointer columns u -> v; returns a table keyed by vertex
with a `rank` column (scaled integers, as the reference does to stay in
exact arithmetic)."""

from __future__ import annotations

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.api import iterate
from pathway_tpu_torch.internals.table import Table


def pagerank(edges: Table, steps: int = 5, damping: int = 85) -> Table:
    """Iterative PageRank over an edge table with columns u, v.

    >>> import pathway_tpu_torch as pw
    >>> edges = pw.debug.table_from_markdown('''
    ... a | b
    ... x | y
    ... y | z
    ... z | y
    ... ''')
    >>> E = edges.select(
    ...     u=edges.pointer_from(pw.this.a), v=edges.pointer_from(pw.this.b)
    ... )
    >>> from pathway_tpu_torch.stdlib.graphs.pagerank import pagerank
    >>> ranks = pagerank(E, steps=3)
    >>> ranks.column_names()
    ['rank']
    """
    # vertex set = endpoints of edges
    us = edges.select(vid=edges.u)
    vs = edges.select(vid=edges.v)
    vertices = (
        us.concat_reindex(vs)
        .groupby(thisclass.this.vid)
        .reduce(vid=thisclass.this.vid)
    )
    degs = edges.groupby(edges.u).reduce(
        vid=edges.u, degree=red.count()
    )
    base = vertices.with_id(vertices.vid).select(rank=10_000)

    def step(ranks):
        # rank flows: each vertex sends rank/degree to its neighbors
        with_deg = degs.with_id(degs.vid)
        edge_flow = edges.select(
            target=edges.v,
            flow=ranks.ix(edges.u, optional=True).rank
            // pw_api.coalesce(with_deg.ix(edges.u, optional=True).degree, 1),
        )
        inflow = edge_flow.groupby(edge_flow.target).reduce(
            vid=edge_flow.target,
            total=red.sum_(edge_flow.flow),
        )
        keyed_inflow = inflow.with_id(inflow.vid)
        return ranks.select(
            rank=(
                pw_api.coalesce(keyed_inflow.ix(ranks.id, optional=True).total, 0)
                * damping
                + 1500 * 10
            )
            // 100
        )

    result = base
    for _ in range(steps):
        result = step(result)
    return result
