"""`pw.sql` in the port against the JAX package's, on the CPU.

Each case is one function `build(pw, tmp)` that builds its input tables
and queries through the package it is given and returns the result tables
to watch (or raises, where the JAX package's test expects a refusal). It
runs once through `pathway_tpu` and once through `pathway_tpu_torch`, and
the two must give the same rows (sorted; floats within 1e-6 relative),
or raise the same exception with the same message. The cases are the
queries of tests/test_sql_advanced.py and the sql tests of
tests/test_misc.py, and, at a small size, the three queries that
chip_smoke.py's phase 14b runs over a sqlite file read by
`pw.io.sqlite.read`: there sqlite3, running the same SQL on the same file,
is the reference as well (exact for integers, 1e-9 relative for floats).
"""

from __future__ import annotations

import math
import os
import random
import sqlite3
import sys

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import runner as jrunner
from pathway_tpu_torch.internals import runner as trunner

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PACKAGES = {"jax": (jpw, jrunner), "port": (tpw, trunner)}
REL = 1e-6


def _norm(v):
    name = type(v).__name__
    if name == "Pointer":
        return ("Pointer", v.value)
    if name == "Error":
        return ("Error",)
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


def _close(a, b, rel=REL) -> bool:
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_close(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
    return type(a) is type(b) and a == b


def _sorted(rows):
    return sorted((_norm(r) for r in rows), key=repr)


def _run(package: str, build, tmp, stream: bool):
    pw, runner = PACKAGES[package]
    pw.G.clear()
    try:
        try:
            tables = build(pw, tmp)
        except Exception as exc:  # noqa: BLE001 — compared across packages
            return ("raises", type(exc).__name__, str(exc))
        if not isinstance(tables, (list, tuple)):
            tables = [tables]
        caps = runner.run_tables(*tables, record_stream=stream)
        out = [_sorted(c.state.rows.values()) for c in caps]
        if stream:
            out += [sorted(((t, _norm(vals), d) for t, (_k, vals, d) in c.stream), key=repr)
                    for c in caps]
        return ("rows", out)
    finally:
        pw.G.clear()


def _assert_same(build, tmp, stream=False):
    jax_out = _run("jax", build, tmp, stream)
    port_out = _run("port", build, tmp, stream)
    assert jax_out[0] == port_out[0], (jax_out, port_out)
    if jax_out[0] == "raises":
        assert jax_out == port_out
        return jax_out
    assert len(jax_out[1]) == len(port_out[1])
    for j, p in zip(jax_out[1], port_out[1]):
        assert len(j) == len(p), (j, p)
        for a, b in zip(j, p):
            assert _close(b, a), (b, a)
    return port_out


# -- the inputs of tests/test_sql_advanced.py and tests/test_misc.py ---------

_SALES = """
    region | amount
    east   | 10
    east   | 20
    west   | 5
    west   | 30
    north  | 7
"""


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


_GV_TIES = """
    g | v
    a | 1
    a | 1
    a | 2
"""

# name -> (query, tables as {name: markdown}, record the update stream)
QUERIES = {
    "cte_basic": (
        "WITH big AS (SELECT region, amount FROM t WHERE amount > 8) "
        "SELECT region, SUM(amount) AS total FROM big GROUP BY region",
        {"t": _SALES},
    ),
    "cte_chain_sees_earlier_cte": (
        "WITH a AS (SELECT region, amount * 2 AS v FROM t), "
        "     b AS (SELECT region, v FROM a WHERE v >= 40) "
        "SELECT region, COUNT(*) AS c FROM b GROUP BY region",
        {"t": _SALES},
    ),
    "cte_shadows_input_table": (
        "WITH t AS (SELECT region FROM t WHERE amount = 30) SELECT region FROM t",
        {"t": _SALES},
    ),
    "subquery_in_from": (
        "SELECT region, total FROM "
        "(SELECT region, SUM(amount) AS total FROM t GROUP BY region) s "
        "WHERE total > 12",
        {"t": _SALES},
    ),
    "subquery_in_join": (
        "SELECT t.region, t.amount, s.total FROM t "
        "JOIN (SELECT region, SUM(amount) AS total FROM t GROUP BY region) s "
        "ON t.region = s.region WHERE t.amount = 30",
        {"t": _SALES},
    ),
    "nested_subqueries": (
        "SELECT region FROM (SELECT region FROM "
        "(SELECT region, amount FROM t WHERE amount > 8) inner_q "
        "WHERE amount < 25) outer_q",
        {"t": _SALES},
    ),
    "where_in_literal_list": (
        "SELECT region, amount FROM t WHERE region IN ('east', 'north')",
        {"t": _SALES},
    ),
    "where_not_in_literal_list": (
        "SELECT region, amount FROM t WHERE region NOT IN ('east', 'west')",
        {"t": _SALES},
    ),
    "where_in_subquery": (
        "SELECT region, amount FROM t WHERE region IN (SELECT r FROM picks)",
        {"t": _SALES, "picks": "r\neast\nnorth"},
    ),
    "where_not_in_subquery_with_other_conjunct": (
        "SELECT region, amount FROM t "
        "WHERE region NOT IN (SELECT r FROM picks) AND amount > 6",
        {"t": _SALES, "picks": "r\neast"},
    ),
    "where_in_subquery_computed": (
        "SELECT region, amount FROM t WHERE region IN "
        "(SELECT region FROM "
        "(SELECT region, SUM(amount) AS s FROM t GROUP BY region) g "
        "WHERE s > 30)",
        {"t": _SALES},
    ),
    "in_subquery_under_or_rejected": (
        "SELECT region FROM t WHERE amount > 100 OR region IN (SELECT region FROM t)",
        {"t": _SALES},
    ),
    "row_number_over_partition_order": (
        "SELECT region, amount, "
        "ROW_NUMBER() OVER (PARTITION BY region ORDER BY amount) AS rn FROM t",
        {"t": _SALES},
    ),
    "row_number_descending": (
        "SELECT region, amount, "
        "ROW_NUMBER() OVER (PARTITION BY region ORDER BY amount DESC) AS rn "
        "FROM t WHERE region = 'east'",
        {"t": _SALES},
    ),
    "sum_over_partition_running": (
        "SELECT region, amount, "
        "SUM(amount) OVER (PARTITION BY region ORDER BY amount) AS rt FROM t",
        {"t": _SALES},
    ),
    "sum_over_partition_whole": (
        "SELECT region, amount, SUM(amount) OVER (PARTITION BY region) AS total FROM t",
        {"t": _SALES},
    ),
    "rank_and_dense_rank_with_ties": (
        "SELECT v, RANK() OVER (PARTITION BY g ORDER BY v) AS r, "
        "DENSE_RANK() OVER (PARTITION BY g ORDER BY v) AS d FROM t",
        {"t": _GV_TIES},
    ),
    "window_running_sum_ties_include_peers": (
        "SELECT v, SUM(v) OVER (PARTITION BY g ORDER BY v) AS rt FROM t",
        {"t": _GV_TIES},
    ),
    "window_no_partition": (
        "SELECT v, ROW_NUMBER() OVER (ORDER BY v) AS rn FROM t",
        {"t": "v\n3\n1\n2"},
    ),
    "window_incremental_update_stream": (
        "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn FROM t",
        {"t": "g | v | __time__\na | 10 | 2\na | 20 | 2\na | 5 | 4"},
        True,
    ),
    "window_null_skipping_aggregates": (
        "SELECT MIN(v) OVER (PARTITION BY g) AS mn, "
        "MAX(v) OVER (PARTITION BY g) AS mx, "
        "AVG(v) OVER (PARTITION BY g) AS av, "
        "COUNT(v) OVER (PARTITION BY g) AS cv, "
        "COUNT(*) OVER (PARTITION BY g) AS cs FROM t",
        {"t": "g | v\na | 5\na |\na | 8"},
    ),
    "window_mixed_order_directions": (
        "SELECT a, b, ROW_NUMBER() OVER (ORDER BY a, b DESC) AS rn FROM t",
        {"t": "a | b\n1 | 1\n1 | 2\n2 | 1"},
    ),
    "window_error_containment": (
        "SELECT g, MIN(v) OVER (PARTITION BY g ORDER BY v) AS m FROM t",
        {"t": "g | v\na | 1\na |\nb | 3"},
    ),
    "window_rejects_group_by_mix": (
        "SELECT region, ROW_NUMBER() OVER (ORDER BY amount) AS rn FROM t GROUP BY region",
        {"t": _SALES},
    ),
    "window_rejects_an_empty_over": (
        "SELECT ROW_NUMBER() OVER () AS rn FROM t",
        {"t": _SALES},
    ),
    "union_all_aligns_by_position": (
        "SELECT a FROM t UNION ALL SELECT b FROM t",
        {"t": "a | b\n1 | 2\n3 | 4"},
    ),
    "union_distinct_dedupes": (
        "SELECT a FROM t UNION SELECT b FROM t",
        {"t": "a | b\n1 | 1\n2 | 3"},
    ),
    "intersect": (
        "SELECT a FROM t INTERSECT SELECT b FROM t",
        {"t": "a | b\n1 | 2\n3 | 4\n2 | 9"},
    ),
    "except": (
        "SELECT a FROM t EXCEPT SELECT b FROM t",
        {"t": "a | b\n1 | 2\n3 | 4\n2 | 9"},
    ),
    "join_using_merges_column": (
        "SELECT t1.a, t1.b, t2.b AS b2 FROM t t1 JOIN t t2 USING (a)",
        {"t": "a | b\n1 | 2\n3 | 4"},
    ),
    "simple_case_expression": (
        "SELECT a, CASE a WHEN 1 THEN 'one' ELSE 'other' END AS w FROM t",
        {"t": "a\n1\n2"},
    ),
    "union_arity_mismatch_raises": (
        "SELECT a, b FROM t UNION ALL SELECT a FROM t",
        {"t": "a | b\n1 | 2"},
    ),
    "right_join_using_coalesces_key": (
        "SELECT k, b FROM l RIGHT JOIN r USING (k)",
        {"l": "k | a\n1 | 100", "r": "k | b\n1 | 10\n5 | 50"},
    ),
    "intersect_binds_tighter_than_union": (
        "SELECT x FROM a UNION SELECT x FROM b INTERSECT SELECT x FROM c",
        {"a": "x\n1", "b": "x\n2", "c": "x\n2"},
    ),
    "chained_union_distinct_single_pass": (
        "SELECT a FROM t UNION SELECT b FROM t UNION SELECT c FROM t",
        {"t": "a | b | c\n1 | 1 | 2"},
    ),
    # tests/test_misc.py
    "select_where": (
        "SELECT a, b + 1 AS c FROM t WHERE a >= 2",
        {"t": "a | b\n1 | 10\n2 | 20\n3 | 30"},
    ),
    "group_by": (
        "SELECT k, SUM(v) AS total, COUNT(*) AS n FROM t GROUP BY k",
        {"t": "k | v\na | 1\na | 2\nb | 5"},
    ),
    "join_on": (
        "SELECT a, b FROM t1 JOIN t2 ON t1.k = t2.k2",
        {"t1": "k | a\n1 | x\n2 | y", "t2": "k2 | b\n1 | 10"},
    ),
    "having": (
        "SELECT k, SUM(v) AS s FROM t GROUP BY k HAVING SUM(v) > 4",
        {"t": "k | v\na | 1\na | 2\nb | 9"},
    ),
    "searched_case": (
        "SELECT CASE WHEN v > 5 THEN 'big' ELSE 'small' END AS size FROM t",
        {"t": "k | v\na | 1\na | 2\nb | 9"},
    ),
}

# the queries the JAX package's tests expect pw.sql to refuse
REFUSED = {
    "in_subquery_under_or_rejected", "window_rejects_group_by_mix",
    "window_rejects_an_empty_over", "union_arity_mismatch_raises",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sql_query_matches_jax(name, tmp_path):
    query, tables, *stream = QUERIES[name]

    def build(pw, tmp):
        named = {k: _md(pw, v) for k, v in tables.items()}
        return pw.sql(query, **named)

    out = _assert_same(build, tmp_path, stream=bool(stream))
    if name in REFUSED:
        assert out[0] == "raises" and out[1] == "ValueError", out
    else:
        assert out[0] == "rows" and out[1][0], f"{name}: no rows"


def test_sql_window_functions_over_random_tables_match_jax(tmp_path):
    """tests/test_sql_advanced.py's randomized window cross-check (ranking,
    running and whole-partition aggregates, ties included) over the same
    30 random tables in both packages; the JAX package's test holds the
    same query to a pandas oracle."""
    rng = random.Random(42)
    query = (
        "SELECT g, o, v, "
        "RANK() OVER (PARTITION BY g ORDER BY o) AS r, "
        "DENSE_RANK() OVER (PARTITION BY g ORDER BY o) AS d, "
        "SUM(v) OVER (PARTITION BY g ORDER BY o) AS rs, "
        "COUNT(*) OVER (PARTITION BY g) AS c, "
        "MIN(v) OVER (PARTITION BY g) AS mn "
        "FROM t"
    )
    for _trial in range(30):
        n = rng.randrange(1, 40)
        rows = [(rng.choice("abc"), rng.randrange(6), rng.randrange(-5, 10)) for _ in range(n)]

        def build(pw, tmp, rows=rows):
            t = pw.debug.table_from_rows(pw.schema_from_types(g=str, o=int, v=int), rows)
            return pw.sql(query, t=t)

        out = _assert_same(build, tmp_path)
        assert len(out[1][0]) == n


# -- 14b's queries over the sqlite connector, sqlite3 the reference ----------

N_SALES = 3000
N_USERS = 50
N_CATEGORIES = 12


@pytest.fixture(scope="module")
def sales_db(tmp_path_factory):
    """chip_smoke.py's phase-14b tables (`sales` and `users`) at a small size."""
    path = str(tmp_path_factory.mktemp("sql") / "sales.db")
    chip_smoke.make_sales_db(path, N_SALES, N_USERS, N_CATEGORIES)
    return path


@pytest.mark.parametrize("name", sorted(chip_smoke.SQL_QUERIES))
def test_sql_over_the_sqlite_connector_matches_jax_and_sqlite3(name, sales_db, tmp_path):
    query = chip_smoke.SQL_QUERIES[name]

    def build(pw, tmp):
        return pw.sql(query, **chip_smoke.sqlite_tables(pw, sales_db))

    out = _assert_same(build, tmp_path)
    con = sqlite3.connect(sales_db)
    want = sorted(con.execute(query).fetchall())
    con.close()
    got = sorted(out[1][0])
    assert len(got) > 0
    assert chip_smoke.rows_agree(got, want, rel=chip_smoke.SQL_REL)


def test_sql_over_the_sqlite_connector_in_one_run(sales_db, tmp_path):
    """14b's shape: both tables read once, the three queries in one run."""

    def build(pw, tmp):
        tables = chip_smoke.sqlite_tables(pw, sales_db)
        return [pw.sql(chip_smoke.SQL_QUERIES[n], **tables) for n in sorted(chip_smoke.SQL_QUERIES)]

    out = _assert_same(build, tmp_path)
    assert [len(rows) for rows in out[1]] == [N_CATEGORIES, N_SALES, N_SALES]
