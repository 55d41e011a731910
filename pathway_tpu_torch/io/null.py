"""pw.io.null — sink that discards output (reference: io/null)."""

from __future__ import annotations

from pathway_tpu_torch.internals.parse_graph import G


def write(table, *, name: str | None = None) -> None:
    def attach(ctx, nodes):
        from pathway_tpu_torch.engine.engine import CaptureNode

        (node,) = nodes
        CaptureNode(ctx.engine, node)

    G.add_sink([table], attach)
