"""Bellman-Ford shortest paths (reference:
python/pathway/stdlib/graphs/bellman_ford/impl.py) — fixed point via
pw.iterate."""

from __future__ import annotations

import math

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import api as pw_api
from pathway_tpu_torch.internals.api import iterate
from pathway_tpu_torch.internals.table import Table


def bellman_ford(vertices: Table, edges: Table) -> Table:
    """vertices: (is_source: bool); edges: (u, v pointers, dist float).
    Returns dist_from_source per vertex.

    >>> import pathway_tpu_torch as pw
    >>> verts = pw.debug.table_from_markdown('''
    ... name | is_source
    ... a    | True
    ... b    | False
    ... ''').with_id_from(pw.this.name)
    >>> e = pw.debug.table_from_markdown('''
    ... us | vs | dist
    ... a  | b  | 2.0
    ... ''')
    >>> E = e.select(
    ...     u=verts.pointer_from(e.us),
    ...     v=verts.pointer_from(e.vs),
    ...     dist=pw.this.dist,
    ... )
    >>> from pathway_tpu_torch.stdlib.graphs.bellman_ford import bellman_ford
    >>> pw.debug.compute_and_print(bellman_ford(verts, E), include_id=False)
    dist
    2.0
    0.0
    """

    base = vertices.select(
        dist=pw_api.if_else(vertices.is_source, 0.0, math.inf)
    )

    def step(dists):
        relaxed = edges.select(
            target=edges.v,
            candidate=dists.ix(edges.u, optional=True).dist + edges.dist,
        )
        best = relaxed.groupby(relaxed.target).reduce(
            vid=relaxed.target,
            best=red.min_(relaxed.candidate),
        )
        keyed = best.with_id(best.vid)
        looked = keyed.ix(dists.id, optional=True)
        return dists.select(
            dist=pw_api.if_else(
                pw_api.coalesce(looked.best, math.inf) < dists.dist,
                pw_api.coalesce(looked.best, math.inf),
                dists.dist,
            )
        )

    return iterate(step, dists=base)
