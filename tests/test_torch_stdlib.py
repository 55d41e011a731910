"""The rest of the stdlib in the port against the JAX package's, on the CPU.

The harness is tests/test_torch_framework.py's: each case `build(pw, tmp)`
runs once through `pathway_tpu` and once through `pathway_tpu_torch` on
the same input (markdown tables, or rows from
`numpy.random.default_rng(seed)`), and the two `pw.io.subscribe` update
streams must be EQUAL, keys and engine times included. The `pw.ml` cases
whose scores come from a KNN index (the JAX package's XLA brute force,
the port's device index on the CPU, that is knn_topk's plain version)
hold every float within 1e-5 plus 1e-5 of its size and everything else
equal.

Covered: `Table.diff`, `stateful.deduplicate`, `statistical.interpolate`,
`pw.utils`, `pw.ml` (KNNIndex, the KNN classifier, classifier_accuracy,
the HMM reducer, fuzzy matching, the digits dataset), `pw.graphs`,
`pw.viz` and `pw.xpacks.connectors.sharepoint`, and the namespace.
"""

from __future__ import annotations

import datetime
import math
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from test_torch_framework import _both

# float tolerance for scores from the two packages' KNN indexes: both are
# f32 brute force over the same vectors, summed in another order. An l2sq
# score is -(|q|^2 - 2 q.x + |x|^2): terms of order 100 at these widths
# that cancel, so f32 rounding (6e-8 relative) of each term moves a score
# of order 10 by about 1e-5 of its size
SCORE_TOL = 1e-5
SCORE_RTOL = 1e-5


def _device(pw):
    """`device="cpu"` for the port's device entry points (None is the card)."""
    return {"device": "cpu"} if pw is tpw else {}


def _assert_close(want, got, path="stream"):
    """Equal, except floats (and float arrays) within SCORE_TOL plus
    SCORE_RTOL of their size."""
    if isinstance(want, float) and isinstance(got, float):
        assert abs(want - got) <= SCORE_TOL + SCORE_RTOL * abs(want), (path, want, got)
    elif isinstance(want, (tuple, list)) and isinstance(got, (tuple, list)):
        if len(want) == 4 and want[:1] == ("ndarray",) and got[:1] == ("ndarray",):
            assert want[1:3] == got[1:3], path
            np.testing.assert_allclose(
                np.asarray(got[3]), np.asarray(want[3]), atol=SCORE_TOL, rtol=SCORE_RTOL
            )
            return
        assert type(want) is type(got) and len(want) == len(got), (path, want, got)
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_close(w, g, f"{path}[{i}]")
    elif isinstance(want, dict) and isinstance(got, dict):
        assert want.keys() == got.keys(), (path, want.keys(), got.keys())
        for k in want:
            _assert_close(want[k], got[k], f"{path}.{k}")
    else:
        assert want == got, (path, want, got)


# -- ordered, stateful, statistical --------------------------------------------


def case_ordered_diff(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        t | v  | w
        1 | 10 | 1.5
        4 | 13 | 2.0
        2 | 11 | -1.0
        7 | 20 | 4.25
        """
    )
    return t.diff(pw.this.t, pw.this.v, pw.this.w)


def case_ordered_diff_instance_stream(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        t | g | v  | __time__ | __diff__
        1 | a | 10 | 2        | 1
        2 | a | 13 | 2        | 1
        1 | b | 5  | 4        | 1
        3 | a | 12 | 6        | 1
        2 | a | 13 | 8        | -1
        2 | b | 9  | 8        | 1
        """
    )
    return pw.ordered.diff(t, t.t, t.v, instance=t.g)


def case_stateful_deduplicate(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        g | v  | __time__
        a | 1  | 2
        b | 4  | 2
        a | 5  | 4
        a | 3  | 6
        b | 10 | 8
        a | 9  | 10
        """
    )
    return pw.stateful.deduplicate(
        t, value=pw.this.v, instance=pw.this.g, acceptor=lambda new, old: new > old + 1
    )


def case_stateful_deduplicate_no_instance(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        v  | __time__
        1  | 2
        2  | 4
        7  | 6
        """
    )
    return pw.stateful.deduplicate(t, col=t.v, acceptor=lambda new, old: new >= old + 2)


def case_statistical_interpolate(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        t  | v   | w
        0  | 0   | 1.0
        2  |     | 3.0
        4  | 4   |
        6  |     | 7.0
        10 | 20  | 11.0
        """
    )
    return t.interpolate(pw.this.t, pw.this.v, pw.this.w)


# -- utils ----------------------------------------------------------------------


def case_utils_unpack_col(pw, tmp):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(pair=tuple), [((1, "x", 2.5),), ((7, "y", -1.0),)]
    )
    return pw.utils.col.unpack_col(t.pair, pw.this.num, pw.this.name, pw.this.f)


def case_utils_unpack_col_schema(pw, tmp):
    class Out(pw.Schema):
        a: int
        b: str

    t = pw.debug.table_from_rows(pw.schema_from_types(pair=tuple), [((3, "z"),), ((4, "w"),)])
    return pw.utils.col.unpack_col(t.pair, schema=Out)


def case_utils_flatten_column(pw, tmp):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=str, xs=tuple), [("a", (1, 2, 3)), ("b", (4,)), ("c", ())]
    )
    return pw.utils.col.flatten_column(t.xs)


def _grouped(pw):
    return pw.debug.table_from_markdown(
        """
        g | v  | w
        a | 1  | 9
        a | 5  | 2
        b | 2  | 3
        b | -4 | 8
        c | 0  | 0
        """
    )


def case_utils_argmax_argmin_rows(pw, tmp):
    t = _grouped(pw)
    return {
        "argmax": pw.utils.argmax_rows(t, t.g, what=t.v),
        "argmin": pw.utils.filtering.argmin_rows(t, pw.this.g, what=pw.this.w),
    }


def case_utils_apply_all_rows(pw, tmp):
    t = _grouped(pw)
    normed = pw.utils.col.apply_all_rows(
        t.v, fun=lambda vs: [x - min(vs) for x in vs], result_col_name="shifted"
    )
    both = pw.utils.col.multiapply_all_rows(
        t.v, t.w,
        fun=lambda vs, ws: ([a + b for a, b in zip(vs, ws)], [a * b for a, b in zip(vs, ws)]),
        result_col_names=["s", "p"],
    )
    return {"apply": normed, "multi": both}


def case_utils_groupby_reduce_majority(pw, tmp):
    t = pw.debug.table_from_markdown(
        """
        label
        x
        y
        x
        z
        x
        """
    )
    return pw.utils.col.groupby_reduce_majority(t.label, majority_col_name="m")


def case_utils_truncate_to_minutes(pw, tmp):
    t0 = datetime.datetime(2024, 5, 1, 9, 30, 0)
    rows = [(t0 + datetime.timedelta(seconds=s, microseconds=s * 1000),) for s in (0, 59, 61, 3599)]
    t = pw.debug.table_from_rows(pw.schema_from_types(ts=pw.DateTimeNaive), rows)
    return t.select(
        minute=pw.apply_with_type(pw.utils.bucketing.truncate_to_minutes, pw.DateTimeNaive, t.ts)
    )


def case_utils_pandas_transformer(pw, tmp):
    import pandas as pd

    t = pw.debug.table_from_markdown(
        """
        foo | bar
        10  | 100
        20  | 200
        30  | -5
        """
    )

    class Output(pw.Schema):
        total: int

    @pw.pandas_transformer(output_schema=Output, output_universe=0)
    def sum_cols(df: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"total": df.sum(axis=1)})

    return sum_cols(t)


# -- ml -----------------------------------------------------------------------

_N, _D = 200, 16


def _ml_data(pw, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, _D)).astype(np.float32) * 3
    labels = rng.integers(0, 4, _N)
    x = (centers[labels] + rng.standard_normal((_N, _D)).astype(np.float32)).astype(np.float32)
    qlab = rng.integers(0, 4, 12)
    q = (centers[qlab] + rng.standard_normal((12, _D)).astype(np.float32)).astype(np.float32)
    data = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, label=int),
        [(x[i], int(labels[i])) for i in range(_N)],
    )
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray), [(q[i],) for i in range(len(q))]
    )
    return data, queries


def _knn_index_case(distance_type, asof_now=False):
    def build(pw, tmp):
        data, queries = _ml_data(pw, seed=1)
        index = pw.ml.index.KNNIndex(
            data.data, data, n_dimensions=_D, distance_type=distance_type, **_device(pw)
        )
        if asof_now:
            return index.get_nearest_items_asof_now(queries.data, k=5)
        return index.get_nearest_items(queries.data, k=5)

    return build


def case_ml_knn_classifier(pw, tmp):
    data, queries = _ml_data(pw, seed=2)
    classify = pw.ml.classifiers.knn_lsh_classifier_train(
        data, L=20, type="euclidean", d=_D, **_device(pw)
    )
    return classify(queries, k=5)


def case_ml_classifier_accuracy(pw, tmp):
    pred = (
        pw.debug.table_from_markdown(
            """
            name | predicted_label
            a    | x
            b    | y
            c    | x
            d    | z
            """
        )
        .with_id_from(pw.this.name)
        .select(predicted_label=pw.this.predicted_label)
    )
    exact = (
        pw.debug.table_from_markdown(
            """
            name | label
            a    | x
            b    | x
            c    | x
            d    | z
            """
        )
        .with_id_from(pw.this.name)
        .select(label=pw.this.label)
    )
    return pw.ml.classifier_accuracy(pred, exact)


def _hmm_graph():
    import networkx as nx

    table = {"HUNGRY": {"GRUMPY": 0.9, "HAPPY": 0.1}, "FULL": {"GRUMPY": 0.2, "HAPPY": 0.8}}
    g = nx.DiGraph()
    for idx, state in enumerate(("HUNGRY", "FULL")):
        g.add_node(
            state, idx=idx,
            calc_emission_log_ppb=lambda obs, s=state: math.log(table[s][obs]),
        )
    for a in ("HUNGRY", "FULL"):
        for b in ("HUNGRY", "FULL"):
            g.add_edge(a, b, log_transition_ppb=math.log(0.7 if a == b else 0.3))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]
    return g


def case_ml_hmm_reducer(pw, tmp):
    obs = pw.debug.table_from_markdown(
        """
        who | observation | __time__
        p   | HAPPY       | 2
        q   | GRUMPY      | 2
        p   | HAPPY       | 4
        p   | GRUMPY      | 6
        q   | GRUMPY      | 6
        p   | GRUMPY      | 8
        """
    )
    return obs.groupby(pw.this.who).reduce(
        pw.this.who, path=pw.ml.create_hmm_reducer(_hmm_graph())(pw.this.observation)
    )


def _fuzzy_sides(pw):
    left = pw.debug.table_from_markdown(
        """
        name
        Alice Smith
        Bob Jones
        Carol White
        """
    )
    right = pw.debug.table_from_markdown(
        """
        who
        smith alice
        jones
        white carol anne
        """
    )
    return left, right


def case_ml_fuzzy_match_tables(pw, tmp):
    left, right = _fuzzy_sides(pw)
    return pw.ml.smart_table_ops.fuzzy_match_tables(left, right)


def case_ml_smart_fuzzy_join(pw, tmp):
    left, right = _fuzzy_sides(pw)
    return pw.ml.smart_table_ops.smart_fuzzy_join(left, right)


def case_ml_digits_dataset(pw, tmp):
    pytest.importorskip("sklearn")
    x_train, y_train, x_test, y_test = pw.ml.datasets.load_digits_sample(sample_size=40)
    return {"y_train": y_train, "y_test": y_test, "x_test": x_test}


# -- graphs -------------------------------------------------------------------


def _edges(pw, seed=3, n_v=12, n_e=30):
    rng = np.random.default_rng(seed)
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, n_v, (n_e, 2)) if a != b}
    rows = [(f"v{a}", f"v{b}", float(rng.integers(1, 10))) for a, b in sorted(pairs)]
    t = pw.debug.table_from_rows(pw.schema_from_types(us=str, vs=str, w=float), rows)
    return t, n_v


def case_graphs_pagerank(pw, tmp):
    t, _ = _edges(pw)
    edges = t.select(u=t.pointer_from(pw.this.us), v=t.pointer_from(pw.this.vs))
    return pw.graphs.pagerank(edges, steps=6)


def case_graphs_bellman_ford(pw, tmp):
    t, n_v = _edges(pw, seed=4)
    verts = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, is_source=bool),
        [(f"v{i}", i == 0) for i in range(n_v)],
    ).with_id_from(pw.this.name)
    edges = t.select(
        u=verts.pointer_from(t.us), v=verts.pointer_from(t.vs), dist=pw.this.w
    )
    return pw.stdlib.graphs.bellman_ford(verts, edges)


def case_graphs_louvain(pw, tmp):
    rows = []
    for base in (0, 10, 20):
        for i in range(4):
            for j in range(i + 1, 4):
                rows.append((f"v{base + i}", f"v{base + j}", 1.0))
    rows += [("v0", "v10", 0.5), ("v13", "v20", 0.25)]
    t = pw.debug.table_from_rows(pw.schema_from_types(un=str, vn=str, weight=float), rows)
    e = t.select(
        u=pw.this.pointer_from(pw.this.un), v=pw.this.pointer_from(pw.this.vn), weight=pw.this.weight
    )
    g = pw.graphs.WeightedGraph.from_vertices_and_weighted_edges(None, e)
    return pw.graphs.louvain_communities(g)


# -- xpacks.connectors -----------------------------------------------------------


class _FakeSharePoint:
    """The client contract sharepoint.read takes through `_client_factory`."""

    FILES = {
        "/site/docs/a.txt": (1_700_000_000.0, 1_690_000_000.0, b"alpha"),
        "/site/docs/sub/b.txt": (1_700_000_100.0, 1_690_000_100.0, b"bravo bravo"),
        "/site/docs/big.bin": (1_700_000_200.0, 1_690_000_200.0, b"x" * 64),
    }

    def list_files(self, root_path, recursive):
        return [
            (p, m, c, len(d)) for p, (m, c, d) in sorted(self.FILES.items())
            if p.startswith(root_path) and (recursive or "/sub/" not in p)
        ]

    def download(self, path):
        return self.FILES[path][2]


def case_connectors_sharepoint_static(pw, tmp):
    return pw.xpacks.connectors.sharepoint.read(
        "https://example.sharepoint.invalid/sites/s",
        root_path="/site/docs",
        mode="static",
        with_metadata=True,
        object_size_limit=32,
        _client_factory=_FakeSharePoint,
    )


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")
}
KNN_CASES = {
    "ml_knn_index_euclidean": _knn_index_case("euclidean"),
    "ml_knn_index_cosine": _knn_index_case("cosine"),
    "ml_knn_index_euclidean_asof_now": _knn_index_case("euclidean", asof_now=True),
    "ml_knn_index_cosine_asof_now": _knn_index_case("cosine", asof_now=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stdlib_stream_matches_jax(case, tmp_path):
    if case == "utils_pandas_transformer":
        pytest.importorskip("pandas")
    if case == "ml_hmm_reducer":
        pytest.importorskip("networkx")
    want, got = _both(CASES[case], str(tmp_path))
    assert want, "the case produced no deltas"
    assert got == want


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_knn_index_stream_matches_jax(case, tmp_path):
    """KNNIndex on the port's device index (device="cpu") against the JAX
    package's: ids, keys, times and labels equal, scores within 1e-5 plus
    1e-5 of their size."""
    want, got = _both(KNN_CASES[case], str(tmp_path))
    assert len(want) == 12
    _assert_close(want, got)


def test_knn_classifier_agrees_with_a_numpy_majority_vote(tmp_path):
    """The port's KNN classifier against numpy: the labels of each query's
    5 nearest rows by euclidean distance, majority vote (no ties on this
    seed)."""
    events = []
    tpw.G.clear()
    try:
        data, queries = _ml_data(tpw, seed=2)
        pred = tpw.ml.classifiers.knn_lsh_classifier_train(
            data, type="euclidean", d=_D, device="cpu"
        )(queries, k=5)
        tpw.io.subscribe(pred, on_change=lambda key, row, time, is_addition: events.append(row))
        tpw.run(monitoring_level=tpw.MonitoringLevel.NONE)
    finally:
        tpw.G.clear()
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((4, _D)).astype(np.float32) * 3
    labels = rng.integers(0, 4, _N)
    x = (centers[labels] + rng.standard_normal((_N, _D)).astype(np.float32)).astype(np.float32)
    qlab = rng.integers(0, 4, 12)
    q = (centers[qlab] + rng.standard_normal((12, _D)).astype(np.float32)).astype(np.float32)
    want = []
    for row in q:
        near = np.argsort(((x - row) ** 2).sum(axis=1))[:5]
        (label, n), *rest = Counter(labels[near].tolist()).most_common()
        assert not rest or rest[0][1] < n
        want.append(label)
    assert sorted(r["predicted_label"] for r in events) == sorted(want)


def test_knn_index_without_a_device_builds_on_the_card_or_raises(monkeypatch):
    """KNNIndex with no `device` asks for the card: without CUDA the run
    raises, and nothing searches on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpw.G.clear()
    try:
        data, queries = _ml_data(tpw)
        index = tpw.ml.index.KNNIndex(data.data, data, n_dimensions=_D)
        tpw.io.subscribe(index.get_nearest_items(queries.data, k=3), on_change=lambda **kw: None)
        with pytest.raises(RuntimeError, match="CUDA"):
            tpw.run(monitoring_level=tpw.MonitoringLevel.NONE)
    finally:
        tpw.G.clear()


# -- viz and the optional client libraries --------------------------------------


def _viz_snapshot(pw):
    pw.G.clear()
    try:
        t = pw.debug.table_from_markdown(
            """
            x | y
            1 | 10
            2 | 20
            3 | 15
            """
        )
        viz = pw.viz.show(t, include_id=False, sorting_col="x")
        handle = t.plot(lambda src: None)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    finally:
        pw.G.clear()
    return str(viz), [v for _k, v in viz.snapshot()], sorted(handle.source.data["y"]), handle


def test_viz_show_and_plot_match_jax_headless():
    """Without bokeh / panel both packages return the headless handles,
    with the same snapshot."""
    want, got = _viz_snapshot(jpw), _viz_snapshot(tpw)
    assert type(got[3]).__name__ == type(want[3]).__name__ == "PlotHandle"
    assert got[:3] == want[:3]


def _error_of(fn):
    with pytest.raises(ImportError) as info:
        fn()
    return type(info.value), str(info.value)


def test_viz_to_matplotlib_raises_the_jax_error_without_matplotlib(monkeypatch):
    handles = {name: _viz_snapshot(pw)[3] for name, pw in (("jax", jpw), ("port", tpw))}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    want = _error_of(lambda: handles["jax"].to_matplotlib("x", "y"))
    got = _error_of(lambda: handles["port"].to_matplotlib("x", "y"))
    assert got == want


def test_sharepoint_client_raises_the_jax_error_without_its_library(monkeypatch):
    monkeypatch.setitem(sys.modules, "office365", None)
    monkeypatch.setitem(sys.modules, "office365.sharepoint", None)
    monkeypatch.setitem(sys.modules, "office365.sharepoint.client_context", None)
    args = ("https://example.sharepoint.invalid", "tenant", "client", "thumb", "/no/cert.pem")
    want = _error_of(lambda: jpw.xpacks.connectors.sharepoint._Office365Client(*args))
    got = _error_of(lambda: tpw.xpacks.connectors.sharepoint._Office365Client(*args))
    assert got == want and "Office365-REST-Python-Client" in got[1]


def test_ml_mnist_needs_the_network_in_both(monkeypatch):
    """load_mnist_sample asks sklearn's fetch_openml, which needs the
    network; with sklearn absent both packages raise the same error."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    want = _error_of(jpw.ml.datasets.load_mnist_sample)
    got = _error_of(tpw.ml.datasets.load_mnist_sample)
    assert got == want


# -- namespace ---------------------------------------------------------------------


def _public(mod):
    return sorted(getattr(mod, "__all__", None) or [n for n in dir(mod) if not n.startswith("_")])


@pytest.mark.parametrize(
    "path",
    ["temporal", "ml", "stdlib", "ordered", "stateful", "statistical", "utils", "viz",
     "stdlib.graphs", "xpacks", "xpacks.connectors", "xpacks.connectors.sharepoint",
     "ml.index", "ml.classifiers", "ml.hmm", "ml.smart_table_ops", "ml.utils", "ml.datasets",
     "utils.col", "utils.filtering", "utils.bucketing"],
)
def test_namespace_has_every_public_name_of_the_jax_package(path):
    jmod, tmod = jpw, tpw
    for part in path.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    missing = [n for n in _public(jmod) if not hasattr(tmod, n)]
    assert not missing, f"pw.{path} lacks {missing}"


def test_top_level_names_of_the_slice_exist():
    names = [
        "temporal", "windowby", "ml", "ordered", "stateful", "statistical", "utils", "viz",
        "pandas_transformer", "tumbling", "sliding", "session", "intervals_over", "window",
        "AsofJoinResult", "IntervalJoinResult", "WindowJoinResult", "graphs",
        "enable_interactive_mode", "LiveTable",
    ]
    for name in names:
        assert hasattr(jpw, name), name
        assert hasattr(tpw, name), name
    assert tpw.window is tpw.temporal and tpw.graphs is tpw.stdlib.graphs
    assert tpw.windowby is tpw.temporal.windowby
