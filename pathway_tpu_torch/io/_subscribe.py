"""pw.io.subscribe — change callbacks (reference:
python/pathway/io/_subscribe.py:16, engine subscribe_table)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.parse_graph import G

# callback type aliases (reference: io/_subscribe.py OnChangeCallback /
# OnFinishCallback — used in signatures and exported for user typing)
OnChangeCallback = Callable[[Any, dict, int, bool], Any]
OnFinishCallback = Callable[[], Any]


def subscribe(
    table,
    on_change: Callable | None = None,
    on_end: Callable | None = None,
    on_time_end: Callable | None = None,
    *,
    skip_persisted_batch: bool = True,
    name: str | None = None,
    sort_by=None,
    on_worker: int | None = None,
) -> None:
    """Register callbacks on table changes. on_change(key, row, time,
    is_addition) fires per delta; on_time_end(time) per closed batch;
    on_end() at end of stream.

    ``on_worker``: multi-worker runs gather the stream onto that worker and
    fire the callbacks only there (REST responders must complete pending
    futures in the process that holds them); default fires per-shard on
    every worker."""
    column_names = table.column_names()

    def attach(ctx, nodes):
        from pathway_tpu_torch.engine.engine import SubscribeNode

        (node,) = nodes
        if on_worker is not None and ctx.engine.worker_count > 1:
            from pathway_tpu_torch.engine.exchange import exchange_to_worker

            node = exchange_to_worker(ctx.engine, node, on_worker)
        SubscribeNode(
            ctx.engine,
            node,
            on_change=on_change,
            on_time_end=on_time_end,
            on_end=on_end,
            column_names=column_names,
            sink_name=name,
        )

    G.add_sink([table], attach)
