"""Row transformers — `@pw.transformer` classes (reference:
python/pathway/internals/row_transformer.py:26, engine side
src/engine/dataflow/complex_columns.rs:493 Computer request/reply protocol).

A transformer declares one inner `ClassArg` class per argument table, with
`input_attribute()` columns read from the table, `@output_attribute` /
`@attribute` computed per row, and `@method` callable columns. Computations
may reference other rows and other tables through
`self.transformer.<table>[ptr].<attr>` — including recursively.

TPU-native departure: the reference compiles attribute access into an
engine-level request/reply dataflow (Computers with memoized prompts,
sharded by key). Here the whole transformer evaluates inside ONE operator
holding the materialized input tables; cross-row references are direct
state lookups and recursive attributes run as a memoized DFS. Semantics
match (same fixed point for well-founded recursion); the trade is operator
locality for the reference's cross-worker generality, which the exchange
layer restores by gathering transformer inputs onto one worker (the same
strategy as the external index, index_node.py)."""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.operators import _DiffCache
from pathway_tpu_torch.engine.stream import TableState
from pathway_tpu_torch.engine.value import Error, Pointer, ref_scalar


# -- attribute descriptors --------------------------------------------------


class AbstractAttribute:
    is_method = False
    is_output = False
    is_input = False

    def __init__(self, func: Callable | None = None, **params):
        self.func = func
        self.params = params
        self.name: str | None = params.get("name")
        self.class_arg: type | None = None

    def __set_name__(self, owner, name):
        if self.name is None:
            self.name = name

    @property
    def output_name(self) -> str:
        return self.params.get("output_name") or self.name


class InputAttribute(AbstractAttribute):
    is_input = True


class InputMethod(AbstractAttribute):
    is_input = True
    is_method = True


class Attribute(AbstractAttribute):
    """Computed, but not part of the output schema."""


class OutputAttribute(AbstractAttribute):
    is_output = True


class Method(AbstractAttribute):
    is_output = True
    is_method = True


def input_attribute(type: Any = None) -> Any:  # noqa: A002
    return InputAttribute(dtype=type)


def input_method(type: Any = None) -> Any:  # noqa: A002
    return InputMethod(dtype=type)


def attribute(func: Callable | None = None, **params) -> Any:
    if func is None:
        return lambda f: Attribute(f, **params)
    return Attribute(func, **params)


def output_attribute(func: Callable | None = None, **params) -> Any:
    if func is None:
        return lambda f: OutputAttribute(f, **params)
    return OutputAttribute(func, **params)


def method(func: Callable | None = None, **params) -> Any:
    if func is None:
        return lambda f: Method(f, **params)
    return Method(func, **params)


# -- ClassArg ----------------------------------------------------------------


class ClassArgMeta(type):
    def __new__(mcls, name, bases, namespace, output=None, **kwargs):
        cls = super().__new__(mcls, name, bases, namespace)
        attrs: Dict[str, AbstractAttribute] = {}
        for base in reversed(cls.__mro__):
            for key, val in vars(base).items():
                if isinstance(val, AbstractAttribute):
                    attrs[val.name or key] = val
                    val.class_arg = cls
        cls._attributes = attrs
        cls._output_schema = output
        if output is not None:
            declared = {
                a.output_name for a in attrs.values() if a.is_output
            }
            expected = set(output.keys()) if hasattr(output, "keys") else set(
                output.columns().keys()
            )
            if not expected <= declared:
                raise RuntimeError(
                    f"output schema validation error: transformer class "
                    f"{name!r} declares outputs {sorted(declared)} but the "
                    f"schema expects {sorted(expected)}"
                )
        return cls

    def __init__(cls, name, bases, namespace, output=None, **kwargs):
        super().__init__(name, bases, namespace)


class ClassArg(metaclass=ClassArgMeta):
    """Base for transformer inner classes (reference:
    row_transformer.py ClassArg:149)."""

    @staticmethod
    def pointer_from(*args, optional: bool = False):
        return ref_scalar(*args, optional=optional)


# -- runtime row reference ---------------------------------------------------


class _BoundMethod:
    """A method column's per-row value. Hash/eq are structural so diff
    caches stay stable across recomputes; calls dispatch against the
    owning node's CURRENT state (a captured evaluator would serve stale
    memoized attributes after later input updates)."""

    __slots__ = ("_node", "_arg_name", "_ptr", "_attr_name")

    def __init__(self, node, arg_name, ptr, attr_name):
        self._node = node
        self._arg_name = arg_name
        self._ptr = ptr
        self._attr_name = attr_name

    def __call__(self, *args):
        if self._node is None:
            # unpickled away from the owning transformer node (another
            # worker's shard, or an inspected snapshot): there is no state
            # to evaluate against
            raise RuntimeError(
                f"transformer method {self._arg_name}.{self._attr_name} "
                "can only be called on the worker hosting its transformer "
                "node (method columns do not evaluate across workers)"
            )
        return self._node.fresh_evaluator().compute(
            self._arg_name, self._ptr, self._attr_name, args
        )

    def __eq__(self, other):
        return (
            isinstance(other, _BoundMethod)
            and (self._arg_name, self._ptr, self._attr_name)
            == (other._arg_name, other._ptr, other._attr_name)
        )

    def __hash__(self):
        return hash((self._arg_name, self._ptr, self._attr_name))

    def __repr__(self):
        return f"<method {self._arg_name}.{self._attr_name} of {self._ptr!r}>"

    # method values live inside emitted rows, so they must pickle for
    # operator snapshots (and survive crossing an exchange without
    # breaking the pipeline); the node binding is process-local and only
    # RowTransformerNode._after_restore re-attaches it — calling an
    # unbound method elsewhere raises, it does not silently misbehave
    def __getstate__(self):
        return (self._arg_name, self._ptr, self._attr_name)

    def __setstate__(self, state):
        self._node = None
        self._arg_name, self._ptr, self._attr_name = state


class RowReference:
    """`self` inside attribute computations; also what
    `self.transformer.<table>[ptr]` returns (reference:
    row_transformer_operator_handler.py RowReference)."""

    __slots__ = ("_evaluator", "_arg_name", "_ptr")

    def __init__(self, evaluator: "_Evaluator", arg_name: str, ptr: Pointer):
        self._evaluator = evaluator
        self._arg_name = arg_name
        self._ptr = ptr

    @property
    def id(self) -> Pointer:
        return self._ptr

    @property
    def transformer(self) -> "_TransformerHandle":
        return _TransformerHandle(self._evaluator)

    def pointer_from(self, *args, optional: bool = False):
        return ref_scalar(*args, optional=optional)

    def __getattr__(self, name: str):
        ev = self._evaluator
        cls = ev.class_args[self._arg_name]
        attr = cls._attributes.get(name)
        if attr is not None:
            if attr.is_method:
                return _BoundMethod(ev, self._arg_name, self._ptr, name)
            return ev.compute(self._arg_name, self._ptr, name, None)
        # plain class members: consts, helper defs, staticmethods
        static = inspect.getattr_static(cls, name)
        if isinstance(static, staticmethod):
            return static.__func__
        if inspect.isfunction(static):
            return static.__get__(self, cls)
        if isinstance(static, property):
            return static.fget(self)
        return static


class _TransformerHandle:
    __slots__ = ("_evaluator",)

    def __init__(self, evaluator):
        self._evaluator = evaluator

    def __getattr__(self, table_name: str):
        if table_name not in self._evaluator.class_args:
            raise AttributeError(table_name)
        return _TableHandle(self._evaluator, table_name)


class _TableHandle:
    __slots__ = ("_evaluator", "_arg_name")

    def __init__(self, evaluator, arg_name):
        self._evaluator = evaluator
        self._arg_name = arg_name

    def __getitem__(self, ptr) -> RowReference:
        return RowReference(self._evaluator, self._arg_name, ptr)


class _Evaluator:
    """Memoized attribute computation over materialized table states.

    Tracks, per output root, which (table, row) pairs its computation
    touched — the node's reverse index over these deps makes later updates
    O(affected) instead of O(table)."""

    def __init__(
        self,
        class_args: Dict[str, type],
        states: Dict[str, TableState],
        column_names: Dict[str, List[str]],
    ):
        self.class_args = class_args
        self.states = states
        self.column_names = column_names
        # memo: key -> (result, deps touched while computing it); memo hits
        # replay their deps so every root's dep set stays complete even
        # when another root already computed the shared attribute
        self.memo: Dict[tuple, tuple] = {}
        self._computing: set = set()
        self._collectors: List[set] = []

    def fresh_evaluator(self) -> "_Evaluator":
        # in-batch _BoundMethod dispatch target (already fresh)
        return self

    def begin_root(self, deps_out: set | None) -> None:
        self._collectors = [deps_out] if deps_out is not None else []

    def _record(self, arg_name: str, ptr: Pointer) -> None:
        for collector in self._collectors:
            collector.add((arg_name, ptr))

    def input_value(self, arg_name: str, ptr: Pointer, attr_name: str):
        self._record(arg_name, ptr)
        row = self.states[arg_name].rows.get(ptr)
        if row is None:
            raise KeyError(
                f"transformer: row {ptr!r} absent from table {arg_name!r}"
            )
        names = self.column_names[arg_name]
        try:
            return row[names.index(attr_name)]
        except ValueError:
            raise KeyError(
                f"transformer: table {arg_name!r} has no column {attr_name!r}"
            ) from None

    def compute(
        self,
        arg_name: str,
        ptr: Pointer,
        attr_name: str,
        call_args: tuple | None,
    ):
        cls = self.class_args[arg_name]
        attr = cls._attributes[attr_name]
        if attr.is_input:
            value = self.input_value(arg_name, ptr, attr_name)
            if attr.is_method:
                return value(*call_args) if call_args is not None else value
            return value
        self._record(arg_name, ptr)
        key = (arg_name, ptr, attr_name, call_args)
        hit = self.memo.get(key)
        if hit is not None:
            result, deps = hit
            for dep in deps:
                self._record(*dep)
            return result
        if key in self._computing:
            raise RecursionError(
                f"transformer: cyclic attribute dependency at "
                f"{arg_name}.{attr_name} for {ptr!r}"
            )
        self._computing.add(key)
        local_deps: set = set()
        self._collectors.append(local_deps)
        try:
            ref = RowReference(self, arg_name, ptr)
            if attr.is_method:
                result = attr.func(ref, *(call_args or ()))
            else:
                result = attr.func(ref)
        finally:
            self._computing.discard(key)
            self._collectors.pop()
        self.memo[key] = (result, local_deps)
        return result


# -- engine operator ---------------------------------------------------------


class RowTransformerNode(Node):
    """One output table of a transformer. Holds every argument table's
    state; recomputes affected outputs per batch with a shared memo
    (reference executes this as complex_columns Computers).

    Multi-output transformers build one node per output ClassArg, each
    with its own state copy — a deliberate trade (transformers with >1
    output table are rare; sharing mutable state across sibling nodes
    would complicate snapshot/restore ordering). The gather exchanges in
    front are shared via exchange_to_worker's memo."""

    name = "row_transformer"

    snapshot_attrs = ("states", "cache", "deps", "rdeps")

    def __init__(
        self,
        engine: Engine,
        input_nodes: List[Node],
        *,
        class_args: Dict[str, type],
        column_names: Dict[str, List[str]],
        out_arg: str,
    ):
        from pathway_tpu_torch.engine.exchange import exchange_to_worker

        input_nodes = [
            exchange_to_worker(engine, n, 0) for n in input_nodes
        ]
        super().__init__(engine, input_nodes)
        self.class_args = class_args
        self.column_names = column_names
        self.out_arg = out_arg
        self.arg_names = list(class_args.keys())
        self.states: Dict[str, TableState] = {
            name: TableState() for name in self.arg_names
        }
        self.cache = _DiffCache()
        # per output row: the (table, row) pairs its computation touched,
        # and the reverse index (what must recompute when a row changes)
        self.deps: Dict[Pointer, set] = {}
        self.rdeps: Dict[tuple, set] = {}

    def fresh_evaluator(self) -> _Evaluator:
        """Evaluator over current state (out-of-batch _BoundMethod calls)."""
        return _Evaluator(self.class_args, self.states, self.column_names)

    def _after_restore(self) -> None:
        # re-bind unpickled method values to this node
        for rows in self.cache.emitted.values():
            for row in rows.values():
                for v in row:
                    if isinstance(v, _BoundMethod) and v._node is None:
                        v._node = self

    def _forget_deps(self, root: Pointer) -> None:
        for dep in self.deps.pop(root, ()):
            roots = self.rdeps.get(dep)
            if roots is not None:
                roots.discard(root)
                if not roots:
                    del self.rdeps[dep]

    def process(self, time: int) -> None:
        dirty: set = set()
        changed = False
        for port, arg_name in enumerate(self.arg_names):
            deltas = self.take(port)
            if not deltas:
                continue
            changed = True
            for key, _row, _diff in deltas:
                dirty |= self.rdeps.get((arg_name, key), set())
                if arg_name == self.out_arg:
                    dirty.add(key)
            self.states[arg_name].apply(
                deltas, source=f"transformer[{arg_name}]"
            )
        if not changed:
            return
        evaluator = _Evaluator(self.class_args, self.states, self.column_names)
        cls = self.class_args[self.out_arg]
        out_attrs = [a for a in cls._attributes.values() if a.is_output]
        out: list = []
        out_rows = self.states[self.out_arg].rows
        for ptr in dirty:
            if ptr not in out_rows:
                self._forget_deps(ptr)
                self.cache.diff(ptr, {}, out)
                continue
            row_deps: set = set()
            evaluator.begin_root(row_deps)
            values = []
            for attr in out_attrs:
                if attr.is_method:
                    values.append(
                        _BoundMethod(self, self.out_arg, ptr, attr.name)
                    )
                    continue
                try:
                    values.append(
                        evaluator.compute(self.out_arg, ptr, attr.name, None)
                    )
                except Exception as exc:  # noqa: BLE001
                    self.log_error(
                        f"transformer {self.out_arg}.{attr.name}: "
                        f"{type(exc).__name__}: {exc}"
                    )
                    from pathway_tpu_torch.engine.value import ERROR

                    values.append(ERROR)
            evaluator.begin_root(None)
            self._forget_deps(ptr)
            self.deps[ptr] = row_deps
            for dep in row_deps:
                self.rdeps.setdefault(dep, set()).add(ptr)
            self.cache.diff(ptr, {ptr: tuple(values)}, out)
        self.emit(time, out)


# -- user-facing transformer object ------------------------------------------


class TransformerResult:
    """Result of calling a transformer: one output Table per ClassArg."""

    def __init__(self, tables: Dict[str, Any]):
        self._tables = tables

    def __getattr__(self, name: str):
        try:
            return self._tables[name]
        except KeyError:
            raise AttributeError(name) from None


class RowTransformer:
    def __init__(self, name: str, class_args: Dict[str, type]):
        self.name = name
        self.class_args = class_args

    @classmethod
    def from_class(cls, transformer_cls) -> "RowTransformer":
        args = {
            name: val
            for name, val in vars(transformer_cls).items()
            if isinstance(val, type) and issubclass(val, ClassArg)
        }
        return cls(transformer_cls.__name__, args)

    def __getattr__(self, item):
        try:
            return self.class_args[item]
        except KeyError:
            raise AttributeError(item) from None

    def __call__(self, *tables, **named_tables) -> TransformerResult:
        from pathway_tpu_torch.internals import dtype as dt
        from pathway_tpu_torch.internals.schema import (
            ColumnSchema,
            schema_from_columns,
        )
        from pathway_tpu_torch.internals.table import Table

        matched: Dict[str, Any] = {}
        for arg_name, table in zip(self.class_args, tables):
            matched[arg_name] = table
        matched.update(named_tables)
        if set(matched) != set(self.class_args):
            raise TypeError(
                f"transformer {self.name} expects tables "
                f"{sorted(self.class_args)}, got {sorted(matched)}"
            )

        column_names = {
            name: matched[name].column_names() for name in self.class_args
        }
        out_tables: Dict[str, Any] = {}
        for out_arg, cls_arg in self.class_args.items():
            out_attrs = [
                a for a in cls_arg._attributes.values() if a.is_output
            ]
            if not out_attrs:
                continue
            cols = {}
            for a in out_attrs:
                hint = Any
                if a.func is not None:
                    sig = inspect.signature(a.func)
                    if sig.return_annotation is not inspect.Signature.empty:
                        hint = sig.return_annotation
                if a.is_method:
                    # method columns carry callables; their reference is
                    # itself callable (expression.py ColumnReference.__call__)
                    dtype = dt.CallableDType((), dt.wrap(hint))
                else:
                    dtype = dt.wrap(hint)
                cols[a.output_name] = ColumnSchema(
                    name=a.output_name, dtype=dtype
                )

            def build(ctx, out_arg=out_arg):
                input_nodes = [
                    ctx.node(matched[name]) for name in self.class_args
                ]
                return RowTransformerNode(
                    ctx.engine,
                    input_nodes,
                    class_args=dict(self.class_args),
                    column_names=column_names,
                    out_arg=out_arg,
                )

            out_tables[out_arg] = Table(
                schema=schema_from_columns(cols),
                universe=matched[out_arg]._universe,
                build=build,
            )
        return TransformerResult(out_tables)


def transformer(cls) -> RowTransformer:
    """Class decorator (reference: pw.transformer)."""
    return RowTransformer.from_class(cls)
