"""Deep UDF purity analysis — the PWT9xx determinism pass.

The engine's headline guarantees (exactly-once sinks, snapshot+replay
failover, fused chains, incremental retraction streams) all assume user
callables are deterministic, side-effect-free and picklable.  This pass
walks the *source* of every UDF reachable from an apply site or a
stateful custom reducer and classifies it:

  * ``deterministic`` — the AST was fully analyzed and nothing impure
    was found; the runtime sanitizer (internals/sanitizer.py) treats the
    callable as certified and the PWT999 parity gate asserts its replay
    hash never diverges.
  * ``impure`` — a concrete nondeterminism source or replay-unsafe side
    effect was found (PWT901/PWT903).
  * ``unknown`` — no source (builtins, C extensions) or only soft
    hazards (PWT902/PWT904/PWT905); the sanitizer still hashes it but
    the parity gate makes no promise.

Findings:
  PWT901  nondeterminism source (time/random/uuid/secrets/os.urandom,
          datetime.now, builtin id())
  PWT902  unordered set/dict iteration feeding the output
  PWT903  replay-unsafe side effect (file/network writes, global-state
          mutation) on a path that stateful operators recompute
  PWT904  closure captures unpicklable state — would disable the
          enclosing node's operator snapshot (build-time twin of the
          runtime "snapshot skips node" warn-once)
  PWT905  mutation of input rows — breaks FusedChainNode batch sharing
  PWT999  parity: a callable *declared* deterministic=True that the
          analysis proves impure (the static half of the contract the
          runtime replay hash enforces)
"""

from __future__ import annotations

import ast
import inspect
import pickle
import textwrap
import weakref
from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.analysis.diagnostics import AnalysisResult, make_diag
from pathway_tpu_torch.analysis.graph import GraphView, op_exprs, walk_expr
from pathway_tpu_torch.internals.expression import ReducerExpression

DETERMINISTIC = "deterministic"
IMPURE = "impure"
UNKNOWN = "unknown"

# module roots whose mere use marks a nondeterminism source (PWT901)
_NONDET_MODULES = {"random", "uuid", "secrets"}
# (module, attr) calls that are nondeterministic; bare module calls from
# `time` are fine to *measure* but not to feed output, so every call
# into these is flagged
_NONDET_CALLS = {
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"), ("time", "process_time"),
    ("os", "urandom"), ("os", "getpid"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}
_NONDET_BUILTINS = {"id"}

# module roots whose use from inside a UDF is a replay-unsafe side
# effect (PWT903): network and subprocess I/O
_SIDE_EFFECT_MODULES = {
    "socket", "requests", "urllib", "http", "subprocess", "smtplib",
}
# method names that mutate their receiver in place (PWT905 when the
# receiver is a parameter)
_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "sort", "reverse",
}


class PurityReport:
    """Classification of one callable."""

    __slots__ = ("name", "verdict", "hazards", "declared_deterministic")

    def __init__(self, name: str):
        self.name = name
        self.verdict = UNKNOWN
        # list of (code, message) pairs, in source order
        self.hazards: List[Tuple[str, str]] = []
        self.declared_deterministic = False

    def codes(self) -> List[str]:
        seen: List[str] = []
        for code, _ in self.hazards:
            if code not in seen:
                seen.append(code)
        return seen

    def to_dict(self) -> Dict[str, Any]:
        return {"verdict": self.verdict, "codes": self.codes()}

    def copy(self) -> "PurityReport":
        dup = PurityReport(self.name)
        dup.verdict = self.verdict
        dup.hazards = list(self.hazards)
        dup.declared_deterministic = self.declared_deterministic
        return dup


def _unwrap(fun: Any) -> Any:
    """Follow decorator/UDF wrapping down to the user's own function."""
    seen = set()
    while id(fun) not in seen:
        seen.add(id(fun))
        for attr in ("__wrapped__", "func", "__func__"):
            inner = getattr(fun, attr, None)
            if callable(inner) and inner is not fun:
                fun = inner
                break
        else:
            return fun
    return fun


def _user_callables(fun: Any, depth: int = 3) -> List[Any]:
    """`fun` plus closure-captured callables defined outside pathway_tpu_torch
    (stateful_single/stateful_many wrap the user's combiner in library
    closures; the user code is in the cells)."""
    out: List[Any] = []
    seen = set()
    stack = [(fun, 0)]
    while stack:
        f, d = stack.pop()
        f = _unwrap(f)
        if id(f) in seen or not callable(f):
            continue
        seen.add(id(f))
        module = getattr(f, "__module__", "") or ""
        if not module.startswith("pathway_tpu_torch"):
            out.append(f)
        if d < depth:
            for cell in getattr(f, "__closure__", None) or ():
                try:
                    v = cell.cell_contents
                except ValueError:  # empty cell
                    continue
                if callable(v):
                    stack.append((v, d + 1))
    return out


def _param_names(tree: ast.AST) -> set:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            a = node.args
            return {
                p.arg
                for p in (
                    list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
                )
            } | ({a.vararg.arg} if a.vararg else set()) | (
                {a.kwarg.arg} if a.kwarg else set()
            )
    return set()


def _dotted_root(node: ast.AST) -> Optional[Tuple[str, str]]:
    """`mod.attr(...)` -> ("mod", "attr"); `mod.sub.attr` -> root+attr."""
    if not isinstance(node, ast.Attribute):
        return None
    attr = node.attr
    base = node.value
    while isinstance(base, ast.Attribute):
        base = base.value
    if isinstance(base, ast.Name):
        return (base.id, attr)
    return None


def _is_unordered_iterable(node: ast.AST) -> bool:
    """Set literals, set()/frozenset() calls, and dict .keys/.values/
    .items views — iteration order is not a replayable contract."""
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in (
            "set", "frozenset"
        ):
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
            "keys", "values", "items"
        ):
            # sorted(d.items()) is handled by the caller (sorted() wraps)
            return True
    return False


class _HazardVisitor(ast.NodeVisitor):
    def __init__(self, params: set):
        self.params = params
        self.hazards: List[Tuple[str, str]] = []
        self._sorted_depth = 0

    def _add(self, code: str, message: str) -> None:
        self.hazards.append((code, message))

    # -- PWT901 / PWT903: calls -------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted_root(node.func)
        if dotted is not None:
            root, attr = dotted
            if root in _NONDET_MODULES:
                self._add("PWT901", f"calls {root}.{attr}()")
            elif (root, attr) in _NONDET_CALLS:
                self._add("PWT901", f"calls {root}.{attr}()")
            elif root in _SIDE_EFFECT_MODULES:
                self._add("PWT903", f"performs I/O via {root}.{attr}()")
            elif node.func.attr in _MUTATING_METHODS and isinstance(
                node.func.value, ast.Name
            ) and node.func.value.id in self.params:
                self._add(
                    "PWT905",
                    f"mutates input {node.func.value.id!r} via "
                    f".{node.func.attr}()",
                )
        elif isinstance(node.func, ast.Name):
            name = node.func.id
            if name in _NONDET_BUILTINS:
                self._add("PWT901", f"calls builtin {name}()")
            elif name == "open":
                mode = ""
                if len(node.args) > 1 and isinstance(
                    node.args[1], ast.Constant
                ):
                    mode = str(node.args[1].value)
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                        mode = str(kw.value.value)
                if any(c in mode for c in "wax+"):
                    self._add("PWT903", f"opens a file for writing "
                                        f"(mode {mode!r})")
            elif name == "sorted":
                # sorted(set(...)) restores a total order — suppress the
                # unordered-iteration lint inside the call
                self._sorted_depth += 1
                self.generic_visit(node)
                self._sorted_depth -= 1
                return
            elif name in ("list", "tuple"):
                self._flag_set_to_sequence(node)
        if isinstance(node.func, ast.Attribute) and node.func.attr == "join":
            self._flag_set_to_sequence(node)
        self.generic_visit(node)

    # -- PWT902: unordered iteration --------------------------------------
    def _check_unordered(self, iter_node: ast.AST, context: str) -> None:
        if self._sorted_depth == 0 and _is_unordered_iterable(iter_node):
            self._add("PWT902", f"iterates an unordered collection "
                                f"in {context}")

    def visit_For(self, node: ast.For) -> None:
        self._check_unordered(node.iter, "a for loop")
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._check_unordered(node.iter, "a comprehension")
        self.generic_visit(node)

    def visit_GeneratorExp(self, node: ast.GeneratorExp) -> None:
        for gen in node.generators:
            self._check_unordered(gen.iter, "a generator expression")
        self.generic_visit(node)

    # str.join(set) / list(set) / tuple(set): set order leaks into a
    # sequence even without an explicit loop
    def _flag_set_to_sequence(self, node: ast.Call) -> None:
        for arg in node.args:
            if self._sorted_depth == 0 and _is_unordered_iterable(arg):
                self._add(
                    "PWT902",
                    "converts an unordered collection to a sequence",
                )

    # -- PWT903: global mutation ------------------------------------------
    def visit_Global(self, node: ast.Global) -> None:
        self._add(
            "PWT903",
            f"declares global {', '.join(node.names)} (state survives "
            "across rows and diverges on replay)",
        )
        self.generic_visit(node)

    # -- PWT905: parameter mutation ---------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_param_store(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_param_store(node.target)
        self.generic_visit(node)

    def _check_param_store(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Subscript, ast.Attribute)):
            base = tgt.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and base.id in self.params:
                self._add(
                    "PWT905", f"assigns into input {base.id!r} in place"
                )


def _source_tree(fun: Any) -> Optional[ast.AST]:
    try:
        src = inspect.getsource(fun)
    except (OSError, TypeError):
        return None
    try:
        return ast.parse(textwrap.dedent(src))
    except SyntaxError:
        # a lambda mid-expression: retry on the bracketed expression
        try:
            return ast.parse("(" + textwrap.dedent(src).strip().rstrip(",")
                             + ")", mode="eval")
        except SyntaxError:
            return None


# source hazards are a property of the def site, not the closure
# instance: rebuilding a graph re-creates function objects but reuses
# their code objects, so keying on __code__ makes repeated analyze runs
# skip the getsource/parse/visit work (closure pickle probing stays
# per-call — it depends on live cell values)
_source_cache: Dict[Any, Tuple[bool, Tuple[Tuple[str, str], ...]]] = {}


def _source_hazards(fun: Any) -> Tuple[bool, Tuple[Tuple[str, str], ...]]:
    code = getattr(fun, "__code__", None)
    if code is not None:
        hit = _source_cache.get(code)
        if hit is not None:
            return hit
    tree = _source_tree(fun)
    if tree is None:
        res: Tuple[bool, Tuple[Tuple[str, str], ...]] = (False, ())
    else:
        visitor = _HazardVisitor(_param_names(tree))
        visitor.visit(tree)
        res = (True, tuple(visitor.hazards))
    if code is not None:
        _source_cache[code] = res
    return res


def _closure_pickle_hazards(fun: Any) -> List[Tuple[str, str]]:
    """PWT904: closure cells (and bound __self__) that do not pickle
    would skip the enclosing node's operator snapshot at runtime."""
    out: List[Tuple[str, str]] = []
    names = getattr(getattr(fun, "__code__", None), "co_freevars", ())
    cells = getattr(fun, "__closure__", None) or ()
    for name, cell in zip(names, cells):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if callable(v):
            continue  # nested functions are analyzed, not pickled here
        try:
            pickle.dumps(v)
        except Exception as exc:  # noqa: BLE001 — the finding IS the point
            out.append((
                "PWT904",
                f"closure variable {name!r} ({type(v).__name__}) does not "
                f"pickle: {exc}",
            ))
    owner = getattr(fun, "__self__", None)
    if owner is not None:
        try:
            pickle.dumps(owner)
        except Exception as exc:  # noqa: BLE001
            out.append((
                "PWT904",
                f"bound instance ({type(owner).__name__}) does not "
                f"pickle: {exc}",
            ))
    return out


# classification is pure in the callable object (source + closure
# cells), and re-running the analyze gate over the same graph builders
# re-presents the same function objects — memoize per callable, weakly
# so dropped UDFs do not pin their closures.  Callers mutate the report
# (declared_deterministic), so hits hand out copies.
_classify_cache: "weakref.WeakKeyDictionary[Any, PurityReport]" = (
    weakref.WeakKeyDictionary()
)


def classify_callable(fun: Any) -> PurityReport:
    """Classify one callable (following UDF/decorator wrapping)."""
    try:
        cached = _classify_cache.get(fun)
    except TypeError:  # unhashable / non-weakrefable callable
        cached = None
    if cached is not None:
        return cached.copy()
    report = _classify_uncached(fun)
    try:
        _classify_cache[fun] = report.copy()
    except TypeError:
        pass
    return report


def _classify_uncached(fun: Any) -> PurityReport:
    def _name_of(f: Any) -> str:
        return getattr(f, "__qualname__", None) or getattr(
            f, "__name__", None
        ) or type(f).__name__

    targets = _user_callables(fun)
    # attribute to the user's own function, not a library wrapper it is
    # buried in (stateful reducers wrap the combiner in library closures)
    module = getattr(_unwrap(fun), "__module__", "") or ""
    named = targets[0] if targets and module.startswith("pathway_tpu_torch") else fun
    report = PurityReport(_name_of(named))
    if not targets:
        return report  # pure-library callable: unknown, no hazards
    analyzed_any = False
    for target in targets:
        report.hazards.extend(_closure_pickle_hazards(target))
        analyzed, src_hazards = _source_hazards(target)
        if not analyzed:
            continue
        analyzed_any = True
        report.hazards.extend(src_hazards)
    hard = {c for c, _ in report.hazards if c in ("PWT901", "PWT903")}
    if hard:
        report.verdict = IMPURE
    elif analyzed_any and not report.hazards:
        report.verdict = DETERMINISTIC
    else:
        report.verdict = UNKNOWN
    return report


def _reducer_callables(op: Any):
    """Stateful custom reducers carry user combiners inside library
    closures (internals/reducers.py stateful_single/stateful_many)."""
    for expr in op_exprs(op):
        for node in walk_expr(expr):
            if isinstance(node, ReducerExpression):
                reducer = node._reducer
                if str(getattr(reducer, "name", "")).startswith("stateful"):
                    compute = getattr(reducer, "compute", None)
                    if callable(compute):
                        yield compute


# stateful operators recompute UDFs on retraction and have their state
# snapshotted — the kinds the replay-safety findings key on (kept in
# sync with passes.STATEFUL_KINDS via tests/test_analysis.py)
def _stateful_kinds() -> set:
    from pathway_tpu_torch.analysis.passes import STATEFUL_KINDS

    return STATEFUL_KINDS


def purity_pass(
    view: GraphView, result: AnalysisResult, *, workers: int = 1
) -> None:
    """Pass 12 — classify every reachable user callable and attach the
    verdict map at result.purity (the sanitizer's certification input)."""
    stateful_kinds = _stateful_kinds()
    verdicts: Dict[str, Dict[str, Any]] = {}
    reports: List[Tuple[Any, Any, PurityReport, Any]] = []

    # the reaches-a-stateful-operator query walks the graph, and only
    # the (rare) PWT903 suppression decision consumes it — resolve it
    # lazily per table instead of paying the walk at every apply site
    _snap_memo: Dict[int, bool] = {}

    def _snap(table, op):
        key = id(table)
        if key not in _snap_memo:
            _snap_memo[key] = op.kind in stateful_kinds or (
                view.reaches_kind(table, stateful_kinds)
            )
        return _snap_memo[key]

    for table, op, sites in view.apply_sites():
        if op.synthetic:
            continue
        for node in sites:
            report = classify_callable(node._fun)
            report.declared_deterministic = bool(node._deterministic)
            reports.append((table, view, report, op))
            verdicts[report.name] = report.to_dict()
    for table, op in view.ops(anchored_only=True):
        if op.synthetic or op.kind not in stateful_kinds:
            continue
        for compute in _reducer_callables(op):
            report = classify_callable(compute)
            reports.append((table, view, report, None))
            verdicts[report.name] = report.to_dict()

    for table, v, report, site_op in reports:
        # site_op None marks a stateful reducer: always on snapshot path
        snapshot_path = True if site_op is None else None
        trace = getattr(table, "_trace", None)
        operator = v.op_label(table)
        emitted = set()
        for code, why in report.hazards:
            if code == "PWT903":
                if snapshot_path is None:
                    snapshot_path = _snap(table, site_op)
                if not snapshot_path:
                    # side effects only corrupt replay when retractions
                    # / snapshots re-run the callable
                    continue
            if (code, why) in emitted:
                continue
            emitted.add((code, why))
            noun = {
                "PWT901": "is nondeterministic",
                "PWT902": "has order-unstable output",
                "PWT903": "has replay-unsafe side effects",
                "PWT904": "would disable its node's operator snapshot",
                "PWT905": "breaks fused-chain batch sharing",
            }[code]
            result.add(make_diag(
                code,
                f"UDF {report.name!r} {noun}: {why}",
                trace=trace,
                operator=operator,
                udf=report.name,
                verdict=report.verdict,
            ))
        if report.declared_deterministic and report.verdict == IMPURE:
            result.add(make_diag(
                "PWT999",
                f"UDF {report.name!r} is declared deterministic=True but "
                "purity analysis proves it impure: "
                + "; ".join(w for c, w in report.hazards
                            if c in ("PWT901", "PWT903")),
                trace=trace,
                operator=operator,
                udf=report.name,
            ))
    if verdicts:
        result.purity = {k: verdicts[k] for k in sorted(verdicts)}


def certified_deterministic(result: AnalysisResult) -> List[str]:
    """Callable names the static pass certifies — the PWT999 runtime
    contract set the sanitizer's replay hash is checked against."""
    purity = result.purity or {}
    return sorted(
        name for name, v in purity.items()
        if v.get("verdict") == DETERMINISTIC
    )


def verify_purity(engine: Any, result: AnalysisResult) -> None:
    """PWT999 parity gate, runtime half.  Mirrors verify_against_plan /
    verify_fusion: after the engine builds (and, in-process, after any
    previous armed run), a callable certified deterministic must never
    have tripped the sanitizer's replay-divergence hash.  The certified
    set is handed to the sanitizer so a *live* divergence of a certified
    callable is attributed as a parity violation, not just a UDF bug."""
    certified = certified_deterministic(result)
    engine.purity_certified = certified
    from pathway_tpu_torch.internals import sanitizer as _sanitizer

    if not _sanitizer.ACTIVE:
        return
    tracker = _sanitizer.tracker()
    tracker.certify(certified)
    for v in tracker.recent_violations():
        if v.get("kind") == "replay_hash" and v.get("udf") in certified:
            result.add(make_diag(
                "PWT999",
                f"UDF {v['udf']!r} is certified deterministic but its "
                "replay hash diverged at runtime "
                f"(worker {v.get('worker')}): static purity analysis "
                "and the dataflow disagree",
                operator="sanitizer",
                udf=v["udf"],
            ))
