"""Reducers: pw.reducers.* API + engine aggregation logic.

TPU-native rebuild of the reference reducer set (reference:
src/engine/reduce.rs:27-45, python/pathway/internals/reducers.py,
custom_reducers.py). Semigroup reducers (count/sum/avg/min/max/arg*/unique/
earliest/latest/count_distinct) maintain per-group *accumulators* updated in
O(delta) per change — matching the reference's O(delta) semigroup reducers
(src/engine/reduce.rs:47-67) — with automatic fallback to full-group
recomputation for non-invertible cases (mixed/unhashable types, custom
reducers), which stays correct for everything.

Each engine entry is `(row_key, args_tuple, time, seq)`; `time/seq` give the
deterministic arrival order that earliest/latest/tuple rely on.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np

from pathway_tpu_torch.engine.value import ERROR, Error
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ReducerExpression,
    smart_wrap,
)

Entry = Tuple[Any, tuple, int, int]  # (row_key, args, time, seq)


class Reducer:
    """A reducer spec: name + engine compute function + dtype rule.

    `make_acc`, when present, builds an O(delta) incremental accumulator;
    the engine falls back to `compute` over the full group when the
    accumulator raises (odd types) or is absent (custom reducers).
    """

    def __init__(
        self,
        name: str,
        compute: Callable[[List[Entry]], Any],
        dtype_fn: Callable[[list], dt.DType] | None = None,
        skip_errors: bool = False,
        make_acc: Callable[[], "Accumulator"] | None = None,
    ):
        self.name = name
        self.compute = compute
        self.dtype_fn = dtype_fn or (lambda arg_dtypes: dt.ANY)
        self.skip_errors = skip_errors
        self.make_acc = make_acc

    def __call__(self, *args, **kwargs) -> ReducerExpression:
        return ReducerExpression(self, *args, **kwargs)

    def __repr__(self):
        return f"<reducer {self.name}>"


# ---------------------------------------------------------------------------
# Incremental accumulators (O(delta) per group update)
# ---------------------------------------------------------------------------


class Accumulator:
    """Incremental per-group aggregate state.

    insert/retract may raise to signal "this input shape is beyond the
    incremental path" — the engine then permanently switches that group's
    reducer to full recomputation. result() may raise to signal an error
    aggregate (engine logs and emits ERROR), mirroring compute()'s behavior.
    """

    def insert(self, row_key: Any, args: tuple, t: Any, s: Any) -> None:
        raise NotImplementedError

    def retract(self, row_key: Any, args: tuple, t: Any, s: Any) -> None:
        raise NotImplementedError

    def result(self) -> Any:
        raise NotImplementedError


class _CountAcc(Accumulator):
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def insert(self, row_key, args, t, s):
        self.n += 1

    def retract(self, row_key, args, t, s):
        self.n -= 1

    def result(self):
        return self.n


class _SumAcc(Accumulator):
    """Running total. Exact for ints/bools; floats may accumulate rounding
    drift under retraction (same trade the reference makes for its semigroup
    float sums). ndarray totals ride numpy broadcasting; anything that
    doesn't support +/- (str, tuple, None) raises on update → fallback."""

    __slots__ = ("total", "err")

    def __init__(self):
        self.total: Any = 0
        self.err = 0

    def insert(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err += 1
            return
        if v is None or isinstance(v, (str, bytes, tuple, list, dict)):
            raise TypeError("non-numeric sum input")
        self.total = self.total + v

    def retract(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err -= 1
            return
        self.total = self.total - v

    def result(self):
        if self.err:
            return ERROR
        return self.total


class _AvgAcc(Accumulator):
    __slots__ = ("total", "n", "err")

    def __init__(self):
        self.total: Any = 0
        self.n = 0
        self.err = 0

    def insert(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err += 1
            return
        if v is None or isinstance(v, (str, bytes, tuple, list, dict)):
            raise TypeError("non-numeric avg input")
        self.total = self.total + v
        self.n += 1

    def retract(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err -= 1
            return
        self.total = self.total - v
        self.n -= 1

    def result(self):
        if self.err:
            return ERROR
        if self.n == 0:
            return None
        return self.total / self.n


class _Rev:
    """Reverses comparison so heapq's min-heap acts as a max-heap. __eq__
    must be real equality, not identity, so tuple comparison falls through
    to later tie-break elements (e.g. argmax's row_key)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return other.v == self.v


class _ExtremumAcc(Accumulator):
    """min/max/argmin/argmax via a lazy-deletion heap: O(log n) amortized
    insert/retract, O(1)+pops result. Heap nodes carry a generation id so
    stale entries (retracted or overwritten rows) are skipped on read."""

    __slots__ = ("heap", "live", "gen", "err", "mode")

    def __init__(self, mode: str):
        self.heap: list = []
        self.live: dict = {}  # row_key -> generation id
        self.gen = 0
        self.err = 0
        self.mode = mode  # 'min' | 'max' | 'argmin' | 'argmax'

    def _heap_key(self, v, row_key):
        if self.mode == "min":
            return (v,)
        if self.mode == "max":
            return (_Rev(v),)
        if self.mode == "argmin":
            return (v, row_key)
        return (_Rev(v), row_key)  # argmax: max value, min key tie-break

    def insert(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err += 1
            return
        self.gen += 1
        self.live[row_key] = self.gen
        heapq.heappush(self.heap, (*self._heap_key(v, row_key), self.gen, v, row_key))

    def retract(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err -= 1
            return
        self.live.pop(row_key, None)
        self._maybe_compact()

    def _maybe_compact(self):
        # lazy-deletion heaps otherwise grow with total inserts ever seen
        if len(self.heap) > 2 * len(self.live) + 16:
            self.heap = [
                node for node in self.heap
                if self.live.get(node[-1]) == node[-3]
            ]
            heapq.heapify(self.heap)

    def result(self):
        if self.err:
            return ERROR
        while self.heap:
            node = self.heap[0]
            gen, v, row_key = node[-3], node[-2], node[-1]
            if self.live.get(row_key) != gen:
                heapq.heappop(self.heap)
                continue
            if self.mode in ("min", "max"):
                return v
            return row_key
        return None


class _OrderAcc(Accumulator):
    """earliest / latest / any: extremum over arrival order (time, seq) —
    lazy heap like _ExtremumAcc but keyed by (t, s), carrying the value."""

    __slots__ = ("heap", "live", "gen", "latest")

    def __init__(self, latest: bool):
        self.heap: list = []
        self.live: dict = {}
        self.gen = 0
        self.latest = latest

    def insert(self, row_key, args, t, s):
        self.gen += 1
        self.live[row_key] = self.gen
        key = _Rev((t, s)) if self.latest else (t, s)
        heapq.heappush(self.heap, (key, self.gen, args[0], row_key))

    def retract(self, row_key, args, t, s):
        self.live.pop(row_key, None)
        if len(self.heap) > 2 * len(self.live) + 16:
            self.heap = [
                node for node in self.heap if self.live.get(node[3]) == node[1]
            ]
            heapq.heapify(self.heap)

    def result(self):
        while self.heap:
            _key, gen, v, row_key = self.heap[0]
            if self.live.get(row_key) != gen:
                heapq.heappop(self.heap)
                continue
            return v
        return None


class _DistinctAcc(Accumulator):
    """count_distinct / unique over a value→multiplicity map."""

    __slots__ = ("counts", "values", "err", "unique_mode")

    def __init__(self, unique_mode: bool = False):
        self.counts: dict = {}
        self.values: dict = {}  # hashable form -> representative original
        self.err = 0
        self.unique_mode = unique_mode

    def insert(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err += 1
            return
        from pathway_tpu_torch.engine.stream import _hashable_one

        hv = _hashable_one(v)
        hash(hv)  # unhashable exotic value -> fallback
        self.counts[hv] = self.counts.get(hv, 0) + 1
        self.values.setdefault(hv, v)

    def retract(self, row_key, args, t, s):
        v = args[0]
        if isinstance(v, Error):
            self.err -= 1
            return
        from pathway_tpu_torch.engine.stream import _hashable_one

        hv = _hashable_one(v)
        n = self.counts.get(hv, 0) - 1
        if n <= 0:
            self.counts.pop(hv, None)
            self.values.pop(hv, None)
        else:
            self.counts[hv] = n

    def result(self):
        if self.unique_mode:
            if self.err:
                return ERROR
            if len(self.counts) == 1:
                return next(iter(self.values.values()))
            if not self.counts:
                return None
            return ERROR
        if self.err:
            return ERROR
        return len(self.counts)


def _arg0(entries: List[Entry]) -> List[Any]:
    return [e[1][0] for e in entries]


def _clean(values: List[Any], skip_nones: bool = False) -> List[Any] | Error:
    if any(isinstance(v, Error) for v in values):
        return ERROR
    if skip_nones:
        return [v for v in values if v is not None]
    return values


def _compute_count(entries):
    return len(entries)


def _compute_sum(entries):
    vals = _clean(_arg0(entries))
    if isinstance(vals, Error):
        return ERROR
    if not vals:
        return 0
    if isinstance(vals[0], np.ndarray):
        out = vals[0].copy()
        for v in vals[1:]:
            out = out + v
        return out
    return sum(vals)


def _compute_min(entries):
    vals = _clean(_arg0(entries))
    if isinstance(vals, Error):
        return ERROR
    return min(vals) if vals else None


def _compute_max(entries):
    vals = _clean(_arg0(entries))
    if isinstance(vals, Error):
        return ERROR
    return max(vals) if vals else None


def _compute_argmin(entries):
    best = None
    for row_key, args, _t, _s in entries:
        v = args[0]
        if isinstance(v, Error):
            return ERROR
        if best is None or (v, row_key) < best[0]:
            best = ((v, row_key), row_key)
    return best[1] if best else None


def _compute_argmax(entries):
    best = None
    for row_key, args, _t, _s in entries:
        v = args[0]
        if isinstance(v, Error):
            return ERROR
        if best is None or (v, _neg_key(row_key)) > best[0]:
            best = ((v, _neg_key(row_key)), row_key)
    return best[1] if best else None


def _neg_key(k):
    # tie-break argmax toward the smallest key, mirroring argmin
    class _Neg:
        __slots__ = ("k",)

        def __init__(self, k):
            self.k = k

        def __lt__(self, other):
            return other.k < self.k

        def __gt__(self, other):
            return other.k > self.k

        def __eq__(self, other):
            return other.k == self.k

    return _Neg(k)


def _compute_avg(entries):
    vals = _clean(_arg0(entries))
    if isinstance(vals, Error):
        return ERROR
    if not vals:
        return None
    return sum(vals) / len(vals)


def _compute_unique(entries):
    vals = _arg0(entries)
    first = vals[0] if vals else None
    for v in vals[1:]:
        if not _eq(v, first):
            return ERROR
    return first


def _eq(a, b):
    from pathway_tpu_torch.engine.value import values_equal

    return values_equal(a, b)


def _compute_any(entries):
    if not entries:
        return None
    return min(entries, key=lambda e: (e[2], e[3]))[1][0]


def _make_tuple_reducer(sort_by_value: bool):
    def compute(entries, skip_nones: bool = False):
        ordered = sorted(entries, key=lambda e: (e[2], e[3]))
        vals = [e[1][0] for e in ordered]
        if skip_nones:
            vals = [v for v in vals if v is not None]
        if any(isinstance(v, Error) for v in vals):
            return ERROR
        if sort_by_value:
            # engine value ordering: None sorts before everything
            # (reference: sorted_tuple with skip_nones=False yields
            # (None, -1, 1) — test_common.py test_tuple_reducer)
            vals = sorted(vals, key=lambda v: (v is not None, v))
        return tuple(vals)

    return compute


def _compute_ndarray(entries, skip_nones: bool = False):
    ordered = sorted(entries, key=lambda e: (e[2], e[3]))
    vals = [e[1][0] for e in ordered]
    if skip_nones:
        vals = [v for v in vals if v is not None]
    if any(isinstance(v, Error) for v in vals):
        return ERROR
    return np.array(vals)


def _compute_earliest(entries):
    if not entries:
        return None
    return min(entries, key=lambda e: (e[2], e[3]))[1][0]


def _compute_latest(entries):
    if not entries:
        return None
    return max(entries, key=lambda e: (e[2], e[3]))[1][0]


def _compute_count_distinct(entries):
    from pathway_tpu_torch.engine.stream import _hashable_one

    vals = _arg0(entries)
    if any(isinstance(v, Error) for v in vals):
        return ERROR
    return len({_hashable_one(v) for v in vals})


def _numeric_dtype(arg_dtypes: list) -> dt.DType:
    if arg_dtypes and dt.unoptionalize(arg_dtypes[0]) in (dt.INT, dt.FLOAT):
        return dt.unoptionalize(arg_dtypes[0])
    return dt.ANY


count = Reducer("count", _compute_count, lambda a: dt.INT, make_acc=_CountAcc)
sum_ = Reducer("sum", _compute_sum, _numeric_dtype, make_acc=_SumAcc)
min_ = Reducer(
    "min",
    _compute_min,
    lambda a: dt.unoptionalize(a[0]) if a else dt.ANY,
    make_acc=lambda: _ExtremumAcc("min"),
)
max_ = Reducer(
    "max",
    _compute_max,
    lambda a: dt.unoptionalize(a[0]) if a else dt.ANY,
    make_acc=lambda: _ExtremumAcc("max"),
)
argmin = Reducer(
    "argmin", _compute_argmin, lambda a: dt.POINTER,
    make_acc=lambda: _ExtremumAcc("argmin"),
)
argmax = Reducer(
    "argmax", _compute_argmax, lambda a: dt.POINTER,
    make_acc=lambda: _ExtremumAcc("argmax"),
)
avg = Reducer("avg", _compute_avg, lambda a: dt.FLOAT, make_acc=_AvgAcc)
unique = Reducer(
    "unique",
    _compute_unique,
    lambda a: dt.unoptionalize(a[0]) if a else dt.ANY,
    make_acc=lambda: _DistinctAcc(unique_mode=True),
)
any_ = Reducer(
    "any",
    _compute_any,
    lambda a: dt.unoptionalize(a[0]) if a else dt.ANY,
    make_acc=lambda: _OrderAcc(latest=False),
)
tuple_ = Reducer(
    "tuple",
    _make_tuple_reducer(sort_by_value=False),
    lambda a: dt.ListDType(a[0]) if a else dt.ANY_TUPLE,
)
sorted_tuple = Reducer(
    "sorted_tuple",
    _make_tuple_reducer(sort_by_value=True),
    lambda a: dt.ListDType(a[0]) if a else dt.ANY_TUPLE,
)
ndarray = Reducer("ndarray", _compute_ndarray, lambda a: dt.ANY_ARRAY)
earliest = Reducer(
    "earliest",
    _compute_earliest,
    lambda a: dt.unoptionalize(a[0]) if a else dt.ANY,
    make_acc=lambda: _OrderAcc(latest=False),
)
latest = Reducer(
    "latest",
    _compute_latest,
    lambda a: dt.unoptionalize(a[0]) if a else dt.ANY,
    make_acc=lambda: _OrderAcc(latest=True),
)
count_distinct = Reducer(
    "count_distinct", _compute_count_distinct, lambda a: dt.INT,
    make_acc=_DistinctAcc,
)
# -- HyperLogLog approximate count-distinct (reference: reduce.rs:930
# CountDistinctApproximateReducer + dataflow.rs:3275, which feeds
# HyperLogLogPlus<Key, Xxh3>; python surface reducers.py:837) --------------


def _hll_canonical_bytes(hv) -> bytes:
    """Type-tagged canonical encoding of a hashable value form — the hash
    must be stable across processes and restarts (Python's builtin hash is
    per-process seeded), like the reference's Xxh3 over Key::for_values."""
    if isinstance(hv, tuple):
        return b"(" + b"|".join(_hll_canonical_bytes(x) for x in hv) + b")"
    return (
        type(hv).__name__.encode()
        + b":"
        + repr(hv).encode("utf-8", "backslashreplace")
    )


def _stable_hash64(args: tuple) -> int:
    from hashlib import blake2b

    from pathway_tpu_torch.engine.stream import _hashable_one

    enc = _hll_canonical_bytes(tuple(_hashable_one(a) for a in args))
    return int.from_bytes(blake2b(enc, digest_size=8).digest(), "little")


class _HllSketch:
    """Plain 64-bit-hash HyperLogLog: 2^precision one-byte registers."""

    __slots__ = ("p", "m", "registers")

    def __init__(self, precision: int):
        self.p = precision
        self.m = 1 << precision
        self.registers = bytearray(self.m)

    def add_hash(self, h: int) -> None:
        idx = h >> (64 - self.p)
        rest = h & ((1 << (64 - self.p)) - 1)
        # leading-zero count of the (64-p)-bit suffix, plus one
        rho = (64 - self.p) - rest.bit_length() + 1
        if rho > self.registers[idx]:
            self.registers[idx] = rho

    def estimate(self) -> int:
        import math

        import numpy as np

        m = self.m
        if m >= 128:
            alpha = 0.7213 / (1 + 1.079 / m)
        elif m == 64:
            alpha = 0.709
        elif m == 32:
            alpha = 0.697
        else:
            alpha = 0.673
        regs = np.frombuffer(bytes(self.registers), dtype=np.uint8)
        est = alpha * m * m / float(np.sum(np.ldexp(1.0, -regs.astype(np.int64))))
        zeros = int(np.count_nonzero(regs == 0))
        if est <= 2.5 * m and zeros:
            est = m * math.log(m / zeros)
        return int(round(est))


class _HllAcc(Accumulator):
    """O(2^precision)-memory insert-only accumulator. A retraction raises,
    which drops the accumulator and sends the group down the full-recompute
    path (still HLL over the surviving rows, so estimates stay consistent)
    — where the reference instead restricts the reducer to append-only
    tables (reference: reducers.py:846, dataflow.rs:3316 asserts diff>0)."""

    __slots__ = ("sketch", "err")

    def __init__(self, precision: int):
        self.sketch = _HllSketch(precision)
        self.err = 0

    def insert(self, row_key, args, t, s):
        if any(isinstance(a, Error) for a in args):
            self.err += 1
            return
        self.sketch.add_hash(_stable_hash64(args))

    def retract(self, row_key, args, t, s):
        raise RuntimeError("HyperLogLog cannot retract; recompute group")

    def result(self):
        if self.err:
            return ERROR
        return self.sketch.estimate()


def _make_compute_hll(precision: int):
    def compute(entries):
        sk = _HllSketch(precision)
        for _rk, args, _t, _s in entries:
            if any(isinstance(a, Error) for a in args):
                return ERROR
            sk.add_hash(_stable_hash64(args))
        return sk.estimate()

    return compute


def count_distinct_approximate(*args, precision: int = 12):
    """HyperLogLog estimate of the number of distinct values (reference:
    reducers.py count_distinct_approximate:837; 2^precision buckets,
    precision in [4, 18]).

    Retraction cost: HLL registers are not subtractable, so ANY
    retraction in a group drops the sketch and recomputes it over the
    group's surviving rows — O(group size) per retracting batch. This is
    strictly more capable than the reference (which restricts the
    reducer to append-only streams) but makes retractions in very large
    groups expensive; for retraction-heavy workloads over big groups use
    exact ``count_distinct`` or pre-aggregate."""
    if not 4 <= precision <= 18:
        raise ValueError(
            "count_distinct_approximate: precision must be between 4 and 18"
        )
    red = Reducer(
        "count_distinct_approximate",
        _make_compute_hll(precision),
        lambda a: dt.INT,
        make_acc=lambda: _HllAcc(precision),
    )
    return red(*args)


def infer_reducer_dtype(expr: ReducerExpression, rec) -> dt.DType:
    reducer: Reducer = expr._reducer
    arg_dtypes = [rec(a) for a in expr._args]
    return reducer.dtype_fn(arg_dtypes)


# ---------------------------------------------------------------------------
# Custom (stateful) reducers — reference: internals/custom_reducers.py
# ---------------------------------------------------------------------------


class BaseCustomAccumulator:
    """User-defined accumulator (reference: custom_reducers.py
    BaseCustomAccumulator:177). Subclass and define from_row / update /
    compute_result; optionally define retract(other) to unlock the O(delta)
    incremental path (update must then be commutative + associative, as in
    the reference's retractable custom reducers)."""

    @classmethod
    def from_row(cls, row):
        raise NotImplementedError

    def update(self, other) -> None:
        raise NotImplementedError

    def retract(self, other) -> None:
        raise NotImplementedError

    def compute_result(self) -> Any:
        raise NotImplementedError


class _CustomAcc(Accumulator):
    """Incremental wrapper over a retract-capable BaseCustomAccumulator."""

    __slots__ = ("cls", "state", "n")

    def __init__(self, cls: type[BaseCustomAccumulator]):
        self.cls = cls
        self.state: BaseCustomAccumulator | None = None
        self.n = 0

    def insert(self, row_key, args, t, s):
        nxt = self.cls.from_row(list(args))
        if self.state is None:
            self.state = nxt
        else:
            self.state.update(nxt)
        self.n += 1

    def retract(self, row_key, args, t, s):
        self.n -= 1
        if self.n <= 0:
            self.state = None
        else:
            self.state.retract(self.cls.from_row(list(args)))

    def result(self):
        if self.state is None:
            return None
        return self.state.compute_result()


def udf_reducer(accumulator: type[BaseCustomAccumulator]):
    """Build a reducer from a BaseCustomAccumulator subclass."""

    def compute(entries: List[Entry]) -> Any:
        ordered = sorted(entries, key=lambda e: (e[2], e[3]))
        acc = None
        for _k, args, _t, _s in ordered:
            nxt = accumulator.from_row(list(args))
            if acc is None:
                acc = nxt
            else:
                acc.update(nxt)
        if acc is None:
            return None
        return acc.compute_result()

    # A subclass that implements retract (anywhere in its MRO) opts into
    # the incremental path.
    make_acc = None
    if accumulator.retract is not BaseCustomAccumulator.retract:
        make_acc = lambda: _CustomAcc(accumulator)  # noqa: E731
    return Reducer(f"udf_{accumulator.__name__}", compute, make_acc=make_acc)


def stateful_many(combine_many: Callable):
    """Reducer from a fold over batches of rows (reference:
    custom_reducers.py stateful_many:36). combine_many(state, rows) where
    rows = [(args_tuple, diff)]."""

    def compute(entries: List[Entry]) -> Any:
        ordered = sorted(entries, key=lambda e: (e[2], e[3]))
        state = None
        rows = [(e[1], 1) for e in ordered]
        state = combine_many(state, rows)
        return state

    return Reducer(f"stateful_{getattr(combine_many, '__name__', 'many')}", compute)


def stateful_single(combine_single: Callable):
    def combine_many(state, rows):
        for args, diff in rows:
            for _ in range(diff):
                state = combine_single(state, *args)
        return state

    return stateful_many(combine_many)


class _ReducersNamespace:
    """pw.reducers.* (reference: internals/reducers.py — the full reducer
    surface, applied inside groupby().reduce()).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... g | v
    ... a | 3
    ... a | 1
    ... b | 5
    ... ''')
    >>> res = t.groupby(pw.this.g).reduce(
    ...     g=pw.this.g,
    ...     total=pw.reducers.sum(pw.this.v),
    ...     n=pw.reducers.count(),
    ...     lo=pw.reducers.min(pw.this.v),
    ...     hi=pw.reducers.max(pw.this.v),
    ...     distinct=pw.reducers.count_distinct(pw.this.v),
    ... )
    >>> pw.debug.compute_and_print(res, include_id=False)
    g | total | n | lo | hi | distinct
    b | 5     | 1 | 5  | 5  | 1
    a | 4     | 2 | 1  | 3  | 2

    ``argmin``/``argmax`` return the row's pointer, resolvable with
    ``Table.ix``:

    >>> t2 = pw.debug.table_from_markdown('''
    ... g | k | v
    ... a | p | 1
    ... a | q | 9
    ... ''')
    >>> r2 = t2.groupby(pw.this.g).reduce(
    ...     pw.this.g, best=pw.reducers.argmax(pw.this.v, pw.this.k)
    ... )
    >>> pw.debug.compute_and_print(
    ...     r2.select(pw.this.g, name=t2.ix(r2.best).k), include_id=False
    ... )
    g | name
    a | q

    ``avg`` divides exactly; ``sorted_tuple``/``tuple`` collect values;
    ``unique`` asserts one distinct value per group:

    >>> t3 = pw.debug.table_from_markdown('''
    ... g | v
    ... a | 2
    ... a | 1
    ... ''')
    >>> r3 = t3.groupby(pw.this.g).reduce(
    ...     pw.this.g,
    ...     mean=pw.reducers.avg(pw.this.v),
    ...     vs=pw.reducers.sorted_tuple(pw.this.v),
    ... )
    >>> pw.debug.compute_and_print(r3, include_id=False)
    g | mean | vs
    a | 1.5  | (1, 2)

    ``earliest``/``latest`` follow engine time (``__time__``):

    >>> t4 = pw.debug.table_from_markdown('''
    ... g | v | __time__
    ... a | 1 | 2
    ... a | 2 | 4
    ... ''')
    >>> r4 = t4.groupby(pw.this.g).reduce(
    ...     pw.this.g,
    ...     first=pw.reducers.earliest(pw.this.v),
    ...     last=pw.reducers.latest(pw.this.v),
    ... )
    >>> pw.debug.compute_and_print(r4, include_id=False)
    g | first | last
    a | 1     | 2
    """

    count = staticmethod(count)
    sum = staticmethod(sum_)
    min = staticmethod(min_)
    max = staticmethod(max_)
    argmin = staticmethod(argmin)
    argmax = staticmethod(argmax)
    avg = staticmethod(avg)
    unique = staticmethod(unique)
    any = staticmethod(any_)
    earliest = staticmethod(earliest)
    latest = staticmethod(latest)
    count_distinct = staticmethod(count_distinct)
    count_distinct_approximate = staticmethod(count_distinct_approximate)
    udf_reducer = staticmethod(udf_reducer)
    stateful_many = staticmethod(stateful_many)
    stateful_single = staticmethod(stateful_single)

    @staticmethod
    def tuple(arg, *, skip_nones: bool = False):
        base = _make_tuple_reducer(sort_by_value=False)
        red = Reducer(
            "tuple",
            lambda entries: base(entries, skip_nones=skip_nones),
            lambda a: dt.ListDType(a[0]) if a else dt.ANY_TUPLE,
        )
        return red(arg)

    @staticmethod
    def sorted_tuple(arg, *, skip_nones: bool = False):
        base = _make_tuple_reducer(sort_by_value=True)
        red = Reducer(
            "sorted_tuple",
            lambda entries: base(entries, skip_nones=skip_nones),
            lambda a: dt.ListDType(a[0]) if a else dt.ANY_TUPLE,
        )
        return red(arg)

    @staticmethod
    def ndarray(arg, *, skip_nones: bool = False):
        red = Reducer(
            "ndarray",
            lambda entries: _compute_ndarray(entries, skip_nones=skip_nones),
            lambda a: dt.ANY_ARRAY,
        )
        return red(arg)


reducers = _ReducersNamespace()
