"""pw.iterate — fixed-point iteration (reference:
src/engine/dataflow/complex_columns.rs:493, Graph::iterate graph.rs:895).

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... v
... 1
... 16
... ''')
>>> def halve_big(tbl):
...     return tbl.select(
...         v=pw.if_else(pw.this.v > 2, pw.this.v // 2, pw.this.v)
...     )
>>> pw.debug.compute_and_print(pw.iterate(halve_big, tbl=t), include_id=False)
v
1
2

The body is re-executed as a nested batch dataflow per iteration until the
outputs stop changing. Each engine time recomputes the fixpoint from the
current input snapshot, so streaming updates re-converge incrementally at the
granularity of times.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.stream import TableState, values_equal_tuple
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe


class _IterationResult:
    def __init__(self, tables: Dict[str, Table]):
        self._tables = tables
        for name, t in tables.items():
            setattr(self, name, t)

    def __iter__(self):
        return iter(self._tables.values())

    def __getitem__(self, name):
        return self._tables[name]


def _normalize_outputs(out, input_names: List[str]) -> Dict[str, Any]:
    if isinstance(out, Table):
        return {input_names[0]: out}
    if isinstance(out, dict):
        return dict(out)
    if hasattr(out, "_asdict"):
        return dict(out._asdict())
    if isinstance(out, tuple):
        return {input_names[i]: t for i, t in enumerate(out)}
    raise TypeError(f"iterate body returned unsupported {type(out)}")


def _snapshot_table(schema, rows: Dict) -> Table:
    def build(ctx):
        from pathway_tpu_torch.engine.engine import StaticSource

        return StaticSource(ctx.engine, dict(rows))

    return Table(schema=schema, universe=Universe(), build=build)


class IterateCoreNode(Node):
    """Holds input snapshots; recomputes the fixpoint each time."""

    name = "iterate"
    snapshot_attrs = ('states',)

    def __init__(
        self,
        engine: Engine,
        inputs: List[Node],
        input_names: List[str],
        input_schemas: List[Any],
        func: Callable,
        iteration_limit: int | None,
        output_names: List[str],
    ):
        super().__init__(engine, inputs)
        self.input_names = input_names
        self.input_schemas = input_schemas
        self.func = func
        self.iteration_limit = iteration_limit
        self.output_names = output_names
        self.states = [TableState() for _ in inputs]
        self.results: Dict[str, Dict] = {name: {} for name in output_names}
        self.changed = False

    def process(self, time: int) -> None:
        any_change = False
        for port in range(len(self.inputs)):
            deltas = self.take(port)
            if deltas:
                self.states[port].apply(deltas, source=self.name)
                any_change = True
        self.changed = any_change
        if not any_change:
            return
        current: Dict[str, Dict] = {
            name: dict(state.rows)
            for name, state in zip(self.input_names, self.states)
        }
        iteration = 0
        while True:
            iteration += 1
            snapshot_tables = {
                name: _snapshot_table(schema, current[name])
                for name, schema in zip(self.input_names, self.input_schemas)
            }
            out = self.func(**snapshot_tables)
            outputs = _normalize_outputs(out, self.input_names)
            from pathway_tpu_torch.internals.runner import run_tables

            ordered = list(outputs.items())
            captures = run_tables(*(t for _, t in ordered))
            new_rows = {
                name: dict(c.state.rows) for (name, _), c in zip(ordered, captures)
            }
            converged = True
            for name in self.input_names:
                if name in new_rows and not _rows_equal(
                    new_rows[name], current[name]
                ):
                    converged = False
                    current[name] = new_rows[name]
            for name, rows in new_rows.items():
                if name not in current:
                    current[name] = rows
            if converged or (
                self.iteration_limit is not None
                and iteration >= self.iteration_limit
            ):
                self.results = {
                    name: new_rows.get(name, current.get(name, {}))
                    for name in self.output_names
                }
                return


def _rows_equal(a: Dict, b: Dict) -> bool:
    if a.keys() != b.keys():
        return False
    return all(values_equal_tuple(a[k], b[k]) for k in a)


class IterateOutputNode(Node):
    name = "iterate_output"
    snapshot_attrs = ('emitted',)

    def __init__(self, engine: Engine, core: IterateCoreNode, output_name: str):
        super().__init__(engine, [core])
        self.core = core
        self.output_name = output_name
        self.emitted: Dict = {}

    def process(self, time: int) -> None:
        self.take(0)
        if not self.core.changed:
            return
        new_rows = self.core.results.get(self.output_name, {})
        out = []
        for k, row in self.emitted.items():
            if k not in new_rows or not values_equal_tuple(new_rows[k], row):
                out.append((k, row, -1))
        for k, row in new_rows.items():
            if k not in self.emitted or not values_equal_tuple(
                self.emitted[k], row
            ):
                out.append((k, row, 1))
        self.emitted = dict(new_rows)
        self.emit(time, out)


class iterate_universe:
    """Marker for an iterated table whose universe may change between
    iterations (reference: internals/operator.py iterate_universe:309).
    This engine's fixed-point loop tracks full table state rather than
    per-universe arrangements, so changing universes are always allowed —
    the marker unwraps to its table and exists for API parity."""

    def __init__(self, table: Table):
        self.table = table


def iterate_impl(func, iteration_limit: int | None = None, **kwargs):
    kwargs = {
        name: (t.table if isinstance(t, iterate_universe) else t)
        for name, t in kwargs.items()
    }
    input_tables: Dict[str, Table] = {
        name: t for name, t in kwargs.items() if isinstance(t, Table)
    }
    if not input_tables:
        raise TypeError("pw.iterate requires at least one Table kwarg")
    input_names = list(input_tables.keys())

    # call the body once on the lazy inputs to learn the output schemas
    probe_out = _normalize_outputs(func(**input_tables), input_names)
    output_names = list(probe_out.keys())
    output_schemas = {name: t._schema for name, t in probe_out.items()}

    cache_key = ("iterate", id(func), tuple(id(t) for t in input_tables.values()))

    def build_core(ctx):
        core = ctx.join_nodes.get(cache_key)
        if core is None:
            nodes = [ctx.node(t) for t in input_tables.values()]
            core = IterateCoreNode(
                ctx.engine,
                nodes,
                input_names,
                [t._schema for t in input_tables.values()],
                func,
                iteration_limit,
                output_names,
            )
            ctx.join_nodes[cache_key] = core
        return core

    from pathway_tpu_torch.internals.parse_graph import record_op

    results: Dict[str, Table] = {}
    for name in output_names:

        def build(ctx, name=name):
            core = build_core(ctx)
            return IterateOutputNode(ctx.engine, core, name)

        results[name] = record_op(
            Table(
                schema=output_schemas[name], universe=Universe(), build=build
            ),
            "iterate",
            tuple(input_tables.values()),
            iteration_limit=iteration_limit,
            output=name,
        )

    if len(results) == 1:
        return next(iter(results.values()))
    return _IterationResult(results)
