"""pw.sql — SQL queries over tables (reference:
python/pathway/internals/sql/processing.py; sqlglot there, a self-contained
recursive-descent translator here).

Supported: SELECT projections/expressions with aliases, WHERE, GROUP BY +
HAVING, aggregate functions (SUM/COUNT/MIN/MAX/AVG), INNER/LEFT/RIGHT
JOIN ... ON / USING (merged columns), UNION [ALL] / INTERSECT / EXCEPT
(positional alignment, SQL set semantics), searched and simple CASE,
WITH-chains (CTEs, reference: processing.py:172), subqueries in FROM and
`WHERE col IN (SELECT ...)` (reference: processing.py:305), and window
functions ROW_NUMBER/RANK/DENSE_RANK/SUM/COUNT/MIN/MAX/AVG with
`OVER (PARTITION BY ... [ORDER BY ... [DESC]])`. Example::

    result = pw.sql("SELECT k, SUM(v) AS total FROM t GROUP BY k", t=t)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from pathway_tpu_torch.internals import reducers as red
from pathway_tpu_torch.internals.api import if_else
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    ColumnConstExpression,
    ColumnExpression,
    IsNoneExpression,
    UnaryOpExpression,
)
from pathway_tpu_torch.internals.table import Table

_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.\d*|\d+)|(?P<str>'[^']*')|(?P<op><>|!=|<=|>=|=|<|>|"
    r"\(|\)|,|\*|\+|-|/|%|\.)|(?P<word>[A-Za-z_][A-Za-z_0-9]*))"
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "as", "join",
    "inner", "left", "right", "outer", "on", "and", "or", "not", "union",
    "all", "order", "asc", "desc", "limit", "is", "null", "case", "when",
    "then", "else", "end", "like", "in", "distinct", "with", "over",
    "partition", "intersect", "except", "using",
}

_WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "sum", "count", "min", "max", "avg",
}

_AGGREGATES = {
    "sum": red.sum_,
    "count": red.count,
    "min": red.min_,
    "max": red.max_,
    "avg": red.avg,
}


class _Tokens:
    def __init__(self, text: str):
        self.tokens: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if m is None:
                if text[pos:].strip():
                    raise ValueError(f"cannot tokenize SQL near {text[pos:pos+20]!r}")
                break
            pos = m.end()
            if m.group("num"):
                self.tokens.append(("num", m.group("num")))
            elif m.group("str"):
                self.tokens.append(("str", m.group("str")[1:-1]))
            elif m.group("op"):
                self.tokens.append(("op", m.group("op")))
            elif m.group("word"):
                word = m.group("word")
                kind = "kw" if word.lower() in _KEYWORDS else "ident"
                self.tokens.append((kind, word.lower() if kind == "kw" else word))
        self.pos = 0

    def peek(self) -> Tuple[str, str] | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise ValueError("unexpected end of SQL")
        self.pos += 1
        return tok

    def accept(self, kind: str, value: str | None = None) -> bool:
        tok = self.peek()
        if tok and tok[0] == kind and (value is None or tok[1] == value):
            self.pos += 1
            return True
        return False

    def expect(self, kind: str, value: str | None = None) -> str:
        tok = self.next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise ValueError(f"expected {value or kind}, got {tok}")
        return tok[1]


class _SqlTranslator:
    def __init__(self, tables: Dict[str, Table]):
        self.tables = dict(tables)
        self._subquery_count = 0

    def query(self, tk: _Tokens) -> Table:
        if tk.accept("kw", "with"):
            # WITH-chain: each CTE sees the ones before it (reference:
            # processing.py:172 CTE handling)
            while True:
                name = tk.expect("ident")
                tk.expect("kw", "as")
                tk.expect("op", "(")
                self.tables[name] = self.select_union(tk)
                tk.expect("op", ")")
                if not tk.accept("op", ","):
                    break
        return self.select_union(tk)

    def select_union(self, tk: _Tokens) -> Table:
        """UNION/EXCEPT level (left-associative); INTERSECT binds tighter
        (SQL standard precedence). Consecutive distinct-UNIONs dedup once
        at the end of the run, not per term."""
        result = self.select_intersect(tk)
        owes_distinct = False
        while True:
            if tk.accept("kw", "union"):
                all_ = tk.accept("kw", "all")
                other = self._positional_rename(
                    result, self.select_intersect(tk)
                )
                if all_ and owes_distinct:
                    result = self._distinct(result)
                    owes_distinct = False
                result = result.concat_reindex(other)
                if not all_:
                    owes_distinct = True
            elif tk.accept("kw", "except"):
                if owes_distinct:
                    result = self._distinct(result)
                    owes_distinct = False
                other = self._positional_rename(
                    result, self.select_intersect(tk)
                )
                result = self._distinct(result).difference(
                    self._distinct(other)
                )
            else:
                break
        if owes_distinct:
            result = self._distinct(result)
        return result

    def select_intersect(self, tk: _Tokens) -> Table:
        result = self.select_statement(tk)
        while tk.accept("kw", "intersect"):
            other = self._positional_rename(
                result, self.select_statement(tk)
            )
            # distinct both sides; groupby keys derive from the row
            # VALUES, so equal rows share ids across tables and the
            # universe intersect is exactly set-intersection
            result = self._distinct(result).intersect(
                self._distinct(other)
            )
        return result

    @staticmethod
    def _positional_rename(first: Table, other: Table) -> Table:
        """UNION/INTERSECT/EXCEPT align columns by POSITION (SQL
        semantics); the combined result uses the first select's names."""
        rn, on = first.column_names(), other.column_names()
        if len(rn) != len(on):
            raise ValueError(
                f"set operation arity mismatch: {len(rn)} vs {len(on)} "
                "columns"
            )
        if rn == on:
            return other
        return other.select(**{a: other[b] for a, b in zip(rn, on)})

    @staticmethod
    def _distinct(table: Table) -> Table:
        cols = [table[c] for c in table.column_names()]
        return table.groupby(*cols).reduce(*cols)

    def select_statement(self, tk: _Tokens) -> Table:
        tk.expect("kw", "select")
        projections: List[Tuple[Optional[str], Any]] = []
        if tk.accept("op", "*"):
            projections.append((None, "*"))
        else:
            while True:
                expr = self.expr(tk)
                alias = None
                if tk.accept("kw", "as"):
                    alias = tk.expect("ident")
                elif tk.peek() and tk.peek()[0] == "ident" and not _next_is_clause(tk):
                    alias = tk.expect("ident")
                projections.append((alias, expr))
                if not tk.accept("op", ","):
                    break
        tk.expect("kw", "from")
        table, scope = self.from_clause(tk)
        where_expr = None
        if tk.accept("kw", "where"):
            where_expr = self.expr(tk)
        group_by: List[Any] = []
        if tk.accept("kw", "group"):
            tk.expect("kw", "by")
            while True:
                group_by.append(self.expr(tk))
                if not tk.accept("op", ","):
                    break
        having_expr = None
        if tk.accept("kw", "having"):
            having_expr = self.expr(tk)

        return self.build(
            table, scope, projections, where_expr, group_by, having_expr
        )

    def from_clause(self, tk: _Tokens):
        """Returns (combined_table, scope) where scope maps each table
        alias to {original column -> column name on the combined table},
        so qualified refs (t2.v) stay correct after joins merge columns."""
        table, alias = self._from_item(tk)
        scope: Dict[str, Dict[str, str]] = {
            alias: {c: c for c in table.column_names()}
        }
        while True:
            how = None
            if tk.accept("kw", "join") or (
                tk.accept("kw", "inner") and tk.expect("kw", "join")
            ):
                how = "inner"
            elif tk.peek() and tk.peek() == ("kw", "left"):
                tk.next()
                tk.accept("kw", "outer")
                tk.expect("kw", "join")
                how = "left"
            elif tk.peek() and tk.peek() == ("kw", "right"):
                tk.next()
                tk.accept("kw", "outer")
                tk.expect("kw", "join")
                how = "right"
            else:
                break
            other, other_name = self._from_item(tk)
            using_cols: List[str] = []
            if tk.accept("kw", "using"):
                tk.expect("op", "(")
                while True:
                    using_cols.append(tk.expect("ident"))
                    if not tk.accept("op", ","):
                        break
                tk.expect("op", ")")
                conds = [
                    table[self._scope_lookup(scope, c)] == other[c]
                    for c in using_cols
                ]
            else:
                tk.expect("kw", "on")
                join_scope = dict(scope)
                join_scope[other_name] = {
                    c: c for c in other.column_names()
                }
                conds = [
                    self._resolve_joined(
                        self.expr(tk), scope, table, other_name, other
                    )
                ]
            jr = table.join(other, *conds, how=how)
            # materialize the join; collision columns from the right side
            # get a disambiguated name tracked through the scope map
            cols: Dict[str, Any] = {}
            taken = set()
            for _alias, mapping in scope.items():
                for _orig, combined_name in mapping.items():
                    if combined_name not in taken:
                        cols[combined_name] = table[combined_name]
                        taken.add(combined_name)
            other_mapping: Dict[str, str] = {}
            for c in other.column_names():
                if c in using_cols:
                    # USING merges the join column with COALESCE
                    # semantics: unmatched right rows (right/outer
                    # joins) contribute their own key value
                    merged = self._scope_lookup(scope, c)
                    from pathway_tpu_torch.internals.api import coalesce

                    cols[merged] = coalesce(table[merged], other[c])
                    other_mapping[c] = merged
                    continue
                out_name = c if c not in taken else f"_{other_name}_{c}"
                while out_name in taken:
                    out_name = "_" + out_name
                cols[out_name] = other[c]
                taken.add(out_name)
                other_mapping[c] = out_name
            table = jr.select(**cols)
            scope[other_name] = other_mapping
        return table, scope

    @staticmethod
    def _scope_lookup(scope, col: str) -> str:
        """The combined-table column name a bare identifier refers to."""
        for mapping in scope.values():
            if col in mapping:
                return mapping[col]
        raise KeyError(f"unknown column {col!r} in USING clause")

    def _from_item(self, tk: _Tokens) -> Tuple[Table, str]:
        """A named table or a parenthesized subquery (reference:
        processing.py:305 Subquery), with an optional alias."""
        if tk.accept("op", "("):
            sub = self.select_union(tk)
            tk.expect("op", ")")
            self._subquery_count += 1
            alias = self._table_alias(tk, f"_subquery_{self._subquery_count}")
            return sub, alias
        name = tk.expect("ident")
        if name not in self.tables:
            raise ValueError(f"unknown table {name!r}")
        return self.tables[name], self._table_alias(tk, name)

    @staticmethod
    def _table_alias(tk: _Tokens, name: str) -> str:
        """`FROM sales AS s` / `FROM sales s` — the alias keys the scope."""
        if tk.accept("kw", "as"):
            return tk.expect("ident")
        nxt = tk.peek()
        if nxt is not None and nxt[0] == "ident":
            return tk.next()[1]
        return name

    # -- expression parsing (returns an AST of ('kind', ...) tuples) ------
    def expr(self, tk: _Tokens):
        return self.or_expr(tk)

    def or_expr(self, tk):
        left = self.and_expr(tk)
        while tk.accept("kw", "or"):
            left = ("binop", "|", left, self.and_expr(tk))
        return left

    def and_expr(self, tk):
        left = self.not_expr(tk)
        while tk.accept("kw", "and"):
            left = ("binop", "&", left, self.not_expr(tk))
        return left

    def not_expr(self, tk):
        if tk.accept("kw", "not"):
            return ("not", self.not_expr(tk))
        return self.cmp_expr(tk)

    def cmp_expr(self, tk):
        left = self.add_expr(tk)
        tok = tk.peek()
        if tok and tok[0] == "op" and tok[1] in ("=", "<>", "!=", "<", "<=", ">", ">="):
            tk.next()
            op = {"=": "==", "<>": "!="}.get(tok[1], tok[1])
            return ("binop", op, left, self.add_expr(tk))
        if tk.accept("kw", "is"):
            negate = tk.accept("kw", "not")
            tk.expect("kw", "null")
            return ("isnull", left, negate)
        negate = False
        if (
            tk.peek() == ("kw", "not")
            and self._peek2(tk) == ("kw", "in")
        ):
            tk.next()
            negate = True
        if tk.accept("kw", "in"):
            return self._in_clause(tk, left, negate)
        return left

    @staticmethod
    def _peek2(tk: _Tokens):
        return (
            tk.tokens[tk.pos + 1] if tk.pos + 1 < len(tk.tokens) else None
        )

    def _in_clause(self, tk: _Tokens, left, negate: bool):
        """`x IN (SELECT ...)` -> semijoin marker; `x IN (a, b, ...)` ->
        equality chain (reference: processing.py:305 Subquery in IN)."""
        tk.expect("op", "(")
        if tk.peek() == ("kw", "select") or tk.peek() == ("kw", "with"):
            sub = self.query(tk)
            tk.expect("op", ")")
            if len(sub.column_names()) != 1:
                raise ValueError(
                    "IN (SELECT ...) subquery must produce exactly one column"
                )
            return ("in_sub", left, sub, negate)
        items = []
        while True:
            items.append(self.expr(tk))
            if not tk.accept("op", ","):
                break
        tk.expect("op", ")")
        node = None
        for item in items:
            eq = ("binop", "==", left, item)
            node = eq if node is None else ("binop", "|", node, eq)
        if negate:
            node = ("not", node)
        return node

    def add_expr(self, tk):
        left = self.mul_expr(tk)
        while True:
            tok = tk.peek()
            if tok and tok[0] == "op" and tok[1] in ("+", "-"):
                tk.next()
                left = ("binop", tok[1], left, self.mul_expr(tk))
            else:
                return left

    def mul_expr(self, tk):
        left = self.unary_expr(tk)
        while True:
            tok = tk.peek()
            if tok and tok[0] == "op" and tok[1] in ("*", "/", "%"):
                tk.next()
                left = ("binop", tok[1], left, self.unary_expr(tk))
            else:
                return left

    def unary_expr(self, tk):
        if tk.accept("op", "-"):
            return ("neg", self.unary_expr(tk))
        return self.atom(tk)

    def atom(self, tk):
        tok = tk.next()
        if tok[0] == "num":
            text = tok[1]
            return ("const", float(text) if "." in text else int(text))
        if tok[0] == "str":
            return ("const", tok[1])
        if tok == ("kw", "null"):
            return ("const", None)
        if tok == ("op", "("):
            inner = self.expr(tk)
            tk.expect("op", ")")
            return inner
        if tok == ("kw", "case"):
            # simple CASE (CASE expr WHEN v ...) desugars to the searched
            # form with equality conditions
            base = None
            if tk.peek() != ("kw", "when"):
                base = self.expr(tk)
            branches = []
            while tk.accept("kw", "when"):
                cond = self.expr(tk)
                if base is not None:
                    cond = ("binop", "==", base, cond)
                tk.expect("kw", "then")
                branches.append((cond, self.expr(tk)))
            default = ("const", None)
            if tk.accept("kw", "else"):
                default = self.expr(tk)
            tk.expect("kw", "end")
            return ("case", branches, default)
        if tok[0] == "ident":
            name = tok[1]
            if tk.accept("op", "("):
                if name.lower() in _AGGREGATES:
                    if tk.accept("op", "*"):
                        arg = None
                    else:
                        arg = self.expr(tk)
                    tk.expect("op", ")")
                    node = ("agg", name.lower(), arg)
                    if tk.peek() == ("kw", "over"):
                        return self._over_clause(tk, name.lower(), arg)
                    return node
                args = []
                if not tk.accept("op", ")"):
                    while True:
                        args.append(self.expr(tk))
                        if not tk.accept("op", ","):
                            break
                    tk.expect("op", ")")
                if tk.peek() == ("kw", "over"):
                    if name.lower() not in _WINDOW_FUNCS:
                        raise ValueError(
                            f"unsupported window function {name!r}"
                        )
                    arg = args[0] if args else None
                    return self._over_clause(tk, name.lower(), arg)
                return ("func", name.lower(), args)
            if tk.accept("op", "."):
                col = tk.expect("ident")
                return ("qualified", name, col)
            return ("ident", name)
        raise ValueError(f"unexpected token {tok}")

    def _over_clause(self, tk: _Tokens, fname: str, arg):
        """`OVER (PARTITION BY ... [ORDER BY ... [DESC]])` -> window node."""
        tk.expect("kw", "over")
        tk.expect("op", "(")
        partition: List[Any] = []
        order: List[Any] = []  # (expr_ast, descending) per ORDER BY key
        if tk.accept("kw", "partition"):
            tk.expect("kw", "by")
            while True:
                partition.append(self.expr(tk))
                if not tk.accept("op", ","):
                    break
        if tk.accept("kw", "order"):
            tk.expect("kw", "by")
            while True:
                e = self.expr(tk)
                desc = False
                if tk.accept("kw", "desc"):
                    desc = True
                else:
                    tk.accept("kw", "asc")
                order.append((e, desc))
                if not tk.accept("op", ","):
                    break
        tk.expect("op", ")")
        if fname in ("row_number", "rank", "dense_rank") and not order:
            raise ValueError(f"{fname}() requires ORDER BY in its OVER clause")
        return ("window", fname, arg, tuple(partition), tuple(order))

    # -- AST -> ColumnExpression -----------------------------------------
    def _resolve_joined(self, ast, scope, table, other_name, other):
        """Resolve an ON condition: the in-progress right side resolves
        against its own table, everything else against the combined one."""

        def override(node):
            kind = node[0]
            if kind == "qualified" and node[1] == other_name:
                return other[node[2]]
            if kind == "ident" and node[1] in other.column_names():
                found_left = any(
                    node[1] in m for m in scope.values()
                )
                if not found_left:
                    return other[node[1]]
            return None

        return self._resolve(ast, scope, table, override=override)

    def _resolve(self, ast, scope, table, override=None):
        def rec(node):
            kind = node[0]
            if override is not None:
                hit = override(node)
                if hit is not None:
                    return hit
            if kind == "const":
                return ColumnConstExpression(node[1])
            if kind == "ident":
                for mapping in scope.values():
                    if node[1] in mapping:
                        return table[mapping[node[1]]]
                if node[1] in table.column_names():
                    return table[node[1]]
                raise ValueError(f"unknown column {node[1]!r}")
            if kind == "qualified":
                tname, col = node[1], node[2]
                if tname in scope and col in scope[tname]:
                    return table[scope[tname][col]]
                raise ValueError(
                    f"unknown column {tname}.{col}"
                )
            if kind == "binop":
                return BinaryOpExpression(node[1], rec(node[2]), rec(node[3]))
            if kind == "neg":
                return UnaryOpExpression("-", rec(node[1]))
            if kind == "not":
                return UnaryOpExpression("~", rec(node[1]))
            if kind == "isnull":
                inner = IsNoneExpression(rec(node[1]), positive=not node[2])
                return inner
            if kind == "case":
                result = rec(node[2]) if node[2] else ColumnConstExpression(None)
                for cond, value in reversed(node[1]):
                    result = if_else(rec(cond), rec(value), result)
                return result
            if kind == "agg":
                reducer = _AGGREGATES[node[1]]
                if node[2] is None:
                    return reducer() if node[1] == "count" else reducer
                return reducer(rec(node[2]))
            if kind == "func":
                raise ValueError(f"unsupported SQL function {node[1]!r}")
            raise ValueError(f"bad AST node {node!r}")

        return rec(ast)

    def _apply_in_sub(self, table, scope, node):
        """`WHERE x IN (SELECT c FROM ...)` as a distinct-then-semijoin
        (reference: processing.py:305 Subquery)."""
        _tag, left_ast, sub, negate = node
        subcol = sub.column_names()[0]
        distinct = sub.groupby(sub[subcol]).reduce(
            **{"_pw_in_val": sub[subcol]}
        )
        left_expr = self._resolve(left_ast, scope, table)
        cond = BinaryOpExpression("==", left_expr, distinct["_pw_in_val"])
        jr = table.join(distinct, cond, id=table.id)
        matched = jr.select(**{c: table[c] for c in table.column_names()})
        if negate:
            return table.difference(matched)
        return matched

    def _apply_windows(self, table, scope, windows):
        """Attach window-function columns; one WindowFunctionNode per
        distinct (PARTITION BY, ORDER BY, direction) signature."""
        sigs: Dict[tuple, list] = {}
        for name, node in windows:
            _tag, fname, arg, partition, order = node
            sigs.setdefault((partition, order), []).append(
                (name, fname, arg)
            )
        for (partition, order), specs in sigs.items():
            table = self._window_wrap(table, scope, partition, order, specs)
        return table

    def _window_wrap(self, table, scope, partition, order, specs):
        from pathway_tpu_torch.engine.operators import WindowFunctionNode
        from pathway_tpu_torch.internals import dtype as dtt
        from pathway_tpu_torch.internals.schema import (
            ColumnSchema,
            schema_from_columns,
        )
        from pathway_tpu_torch.internals.table import _compile_on

        part_exprs = [self._resolve(a, scope, table) for a in partition]
        order_exprs = [self._resolve(a, scope, table) for a, _d in order]
        directions = tuple(d for _a, d in order)
        arg_exprs = [
            self._resolve(a, scope, table) if a is not None else None
            for (_n, _f, a) in specs
        ]
        spec_list = [(f, bool(order)) for (_n, f, _a) in specs]

        def build(ctx):
            node = ctx.node(table)

            def composite(progs):
                if not progs:
                    return None
                if len(progs) == 1:
                    return progs[0]

                def fn(keys, rows):
                    cols = [p(keys, rows) for p in progs]
                    return [
                        tuple(c[i] for c in cols) for i in range(len(keys))
                    ]

                return fn

            part_prog = composite(
                [_compile_on(ctx, [table], e) for e in part_exprs]
            ) or (lambda keys, rows: [0] * len(keys))
            order_prog = composite(
                [_compile_on(ctx, [table], e) for e in order_exprs]
            )
            arg_progs = [
                _compile_on(ctx, [table], e) if e is not None else None
                for e in arg_exprs
            ]
            return WindowFunctionNode(
                ctx.engine,
                node,
                part_prog,
                order_prog,
                spec_list,
                arg_progs,
                directions=directions,
            )

        schema_cols = {
            nm: ColumnSchema(name=nm, dtype=table._schema[nm].dtype)
            for nm in table.column_names()
        }
        for nm, f, _a in specs:
            dtype = (
                dtt.INT
                if f in ("row_number", "rank", "dense_rank", "count")
                else dtt.ANY
            )
            schema_cols[nm] = ColumnSchema(name=nm, dtype=dtype)
        return Table(
            schema=schema_from_columns(schema_cols),
            universe=table._universe,
            build=build,
        )

    def build(self, table, scope, projections, where_ast, group_asts, having_ast):
        if where_ast is not None:
            # IN-subquery conjuncts become semijoins; the rest filter
            plain: List[Any] = []
            in_subs: List[Any] = []
            for c in _conjuncts(where_ast):
                if isinstance(c, tuple) and c[0] == "in_sub":
                    in_subs.append(c)
                elif _contains_in_sub(c):
                    raise ValueError(
                        "IN (SELECT ...) is only supported as a top-level "
                        "AND conjunct of WHERE"
                    )
                else:
                    plain.append(c)
            if plain:
                combined = plain[0]
                for c in plain[1:]:
                    combined = ("binop", "&", combined, c)
                # filtering keeps column names, so the scope maps stay valid
                table = table.filter(self._resolve(combined, scope, table))
            for c in in_subs:
                table = self._apply_in_sub(table, scope, c)
        windows: List[tuple] = []
        new_projections = []
        for alias, ast in projections:
            if ast == "*":
                new_projections.append((alias, ast))
                continue
            new_projections.append(
                (alias, _extract_windows(ast, windows))
            )
        projections = new_projections
        if windows:
            if group_asts:
                raise ValueError(
                    "window functions cannot be combined with GROUP BY"
                )
            table = self._apply_windows(table, scope, windows)
        if group_asts:
            group_exprs = [
                self._resolve(a, scope, table) for a in group_asts
            ]
            cols = {}
            for i, (alias, ast) in enumerate(projections):
                if ast == "*":
                    raise ValueError("SELECT * with GROUP BY is not supported")
                expr = self._resolve(ast, scope, table)
                name = alias or _default_name(ast, i)
                cols[name] = expr
            if having_ast is not None:
                cols["__having__"] = self._resolve(having_ast, scope, table)
            grouped = table.groupby(*group_exprs).reduce(**cols)
            if having_ast is not None:
                grouped = grouped.filter(grouped["__having__"]).without(
                    "__having__"
                )
            return grouped
        cols = {}
        for i, (alias, ast) in enumerate(projections):
            if ast == "*":
                for c in table.column_names():
                    cols[c] = table[c]
                continue
            expr = self._resolve(ast, scope, table)
            cols[alias or _default_name(ast, i)] = expr
        return table.select(**cols)


def _conjuncts(ast) -> List[Any]:
    if isinstance(ast, tuple) and ast[0] == "binop" and ast[1] == "&":
        return _conjuncts(ast[2]) + _conjuncts(ast[3])
    return [ast]


def _contains_in_sub(ast) -> bool:
    if isinstance(ast, tuple):
        if ast[0] == "in_sub":
            return True
        return any(_contains_in_sub(x) for x in ast)
    if isinstance(ast, list):
        return any(_contains_in_sub(x) for x in ast)
    return False


def _extract_windows(ast, found: List[tuple]):
    """Pull ("window", ...) nodes out of an AST, rewriting each into a
    reference to its computed column."""
    if isinstance(ast, tuple):
        if ast[0] == "window":
            name = f"_pw_win_{len(found)}"
            found.append((name, ast))
            return ("ident", name)
        return tuple(_extract_windows(x, found) for x in ast)
    if isinstance(ast, list):
        return [_extract_windows(x, found) for x in ast]
    return ast


def _default_name(ast, i: int) -> str:
    if isinstance(ast, tuple):
        if ast[0] == "ident":
            return ast[1]
        if ast[0] == "qualified":
            return ast[2]
        if ast[0] == "agg" and isinstance(ast[2], tuple) and ast[2][0] == "ident":
            return ast[2][1]
    return f"col_{i}"


def _next_is_clause(tk: _Tokens) -> bool:
    tok = tk.peek()
    return tok is not None and tok[0] == "kw"


def sql(query: str, **tables: Table) -> Table:
    """Run a SQL query over the given tables (reference: pw.sql,
    internals/sql/processing.py).

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('''
    ... region | amount
    ... east   | 10
    ... east   | 20
    ... west   | 5
    ... ''')
    >>> res = pw.sql(
    ...     "SELECT region, SUM(amount) AS total FROM t "
    ...     "GROUP BY region HAVING SUM(amount) > 10",
    ...     t=t,
    ... )
    >>> pw.debug.compute_and_print(res, include_id=False)
    region | total
    east   | 30
    """
    translator = _SqlTranslator(tables)
    tk = _Tokens(query)
    result = translator.query(tk)
    if tk.peek() is not None:
        raise ValueError(f"unparsed SQL from token {tk.peek()!r}")
    return result
