"""Vectorized groupby-reduce — the engine's columnar host hot path.

The classic `ReduceNode` (operators.py) keeps per-row bucket entries and
calls accumulator methods row by row; that per-row Python caps the host
loop at tens of krows/s while the reference's compiled engine streams
millions (src/engine/reduce.rs semigroup reducers over timely batches;
integration_tests/wordcount/base.py:19 is the 5M-line harness).
`VectorReduceNode` processes each delta batch columnar-ly instead:

- group codes: one dict lookup per row maps the group key to a dense int
  index; everything downstream is numpy over int arrays
- count: the group's live-row counter (`nlive`), maintained with one
  `np.bincount` per batch — no per-row reducer state at all
- sum: `np.add.at` into int64/float64 total arrays when the batch column
  converts cleanly; a per-row object loop mirroring `_SumAcc` (Error
  counting, exact big ints) otherwise
- min/max: per-group value->multiplicity bags with a cached extremum and
  lazy rescan when the current extremum is retracted

Chosen at graph-build time (internals/groupbys.py) only when the static
facts allow it: every reducer in VECTOR_REDUCERS, reducer argument dtypes
non-optional numeric, deterministic argument expressions (retractions
recompute args from the retraction row instead of replaying stored
insert-time values), and no sort_by / custom ids.  Anything else builds
the classic node.  Both share the emit contract, so downstream operators
cannot tell them apart.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pathway_tpu_torch.engine.engine import Engine, Node
from pathway_tpu_torch.engine.stream import Delta, values_equal_tuple
from pathway_tpu_torch.engine.value import ERROR, Error, Pointer
from pathway_tpu_torch.internals import provenance as _provenance

VECTOR_REDUCERS = {"count", "sum", "min", "max", "avg", "any"}

_INT64_MAX = np.iinfo(np.int64).max


class _VecCount:
    """count: reads the node-maintained live-row counter."""

    kind = "count"
    needs_col = False
    needs_seq = False

    def state_init(self):
        return None

    def apply_batch(self, state, codes, n_groups, col, signs, keys, time, seqs):
        pass

    def result(self, state, node, g):
        return int(node.nlive_list[g])


class _VecSum:
    """sum: int64/float64 vector lanes with an exact object fallback.

    Totals live in a per-group Python list so int sums stay exact
    arbitrary-precision (`_SumAcc` parity).  Lanes are gated on BOTH the
    declared column dtype and the batch's natural numpy dtype: an
    int column whose values exceed int64 range lands in uint64/float64
    under `np.asarray` (silent wrap / precision loss), so anything that
    does not convert to a clean matching kind takes the object lane.

    Optional columns (`optional=True`) track a per-group None
    multiplicity via a validity mask and split the numeric lane over the
    valid rows.  While a group holds a live None its result is ERROR —
    the classic `_SumAcc` raises on None, permanently demoting the group
    to full recomputation whose `sum(vals)` then raises per batch (the
    classic node logs the interpreter's TypeError text; this node logs a
    stable one-line equivalent).  Once every None is retracted both
    paths return the numeric total again."""

    kind = "sum"
    needs_col = True
    needs_seq = False
    track_n = False  # avg: also count numeric live contributions

    def __init__(self, arg_kind: str = "i", optional: bool = False):
        # declared dtype kind: 'i' (int/bool) or 'f' (float)
        self.arg_kind = arg_kind
        self.optional = optional

    def state_init(self):
        # tot: per-group Python numbers; err: per-group Error
        # multiplicity; nones: per-group None multiplicity; n: per-group
        # numeric live count (maintained only when track_n)
        return {"tot": [], "err": [], "nones": [], "n": []}

    def apply_batch(self, state, codes, n_groups, col, signs, keys, time, seqs):
        tot, err = state["tot"], state["err"]
        nones, nnum = state["nones"], state["n"]
        while len(tot) < n_groups:
            tot.append(0)
            err.append(0)
            nones.append(0)
            nnum.append(0)
        n = len(col)
        if self.optional and n:
            valid = np.fromiter((v is not None for v in col), np.bool_, n)
            if not valid.all():
                inv = ~valid
                contrib = np.bincount(
                    codes[inv], weights=signs[inv], minlength=n_groups
                )
                for g in np.nonzero(contrib)[0]:
                    nones[g] += int(contrib[g])
                codes = codes[valid]
                signs = signs[valid]
                col = [v for v, ok in zip(col, valid) if ok]
                n = len(col)
        try:
            arr0 = np.asarray(col)
            kind = arr0.dtype.kind
        except (TypeError, ValueError):
            kind = "O"
        fast = False
        if self.arg_kind == "i" and kind in ("b", "i"):
            # int lane — kind 'u' (values >= 2^63) and 'f' (mixed
            # magnitudes promoted by asarray) would wrap or lose
            # precision, so they fall through to the exact object lane.
            # Per-batch contributions ride float64 inside bincount, so
            # keep them provably below 2^52 for exactness.
            arr = arr0.astype(np.int64)
            if not n or int(np.abs(arr).max()) <= (1 << 52) // n:
                contrib = np.bincount(
                    codes, weights=arr * signs, minlength=n_groups
                )
                for g in np.nonzero(contrib)[0]:
                    tot[g] = tot[g] + int(contrib[g])
                fast = True
        elif self.arg_kind == "f" and kind in ("b", "i", "f"):
            contrib = np.bincount(
                codes,
                weights=arr0.astype(np.float64) * signs,
                minlength=n_groups,
            )
            for g in np.nonzero(contrib)[0]:
                tot[g] = tot[g] + float(contrib[g])
            fast = True
        if fast:
            if self.track_n and n:
                nc = np.bincount(codes, weights=signs, minlength=n_groups)
                for g in np.nonzero(nc)[0]:
                    nnum[g] += int(nc[g])
            return
        # object lane: big ints / Error values (non-numerics cannot reach
        # here — the build-time dtype gate admits only numeric columns)
        track_n = self.track_n
        for i in range(n):
            v = col[i]
            g = codes[i]
            # int(): a numpy sign leaking into the running totals would
            # promote results to numpy scalars (emit contract is plain)
            s = int(signs[i])
            if isinstance(v, Error):
                err[g] += s
                continue
            if s > 0:
                tot[g] = tot[g] + v
            else:
                tot[g] = tot[g] - v
            if track_n:
                nnum[g] += s

    def result(self, state, node, g):
        err = state["err"]
        if g < len(err) and err[g]:
            return ERROR
        nones = state["nones"]
        if g < len(nones) and nones[g]:
            # classic parity: the demoted group's recompute raises
            # TypeError on the live None every batch (logged + ERROR)
            node.log_error(f"reducer {self.kind}: non-numeric input (None)")
            return ERROR
        tot = state["tot"]
        return tot[g] if g < len(tot) else 0


class _VecAvg(_VecSum):
    """avg: the sum machinery plus a per-group numeric live count;
    result is total/n (`_AvgAcc` parity: Errors and live Nones yield
    ERROR, an empty group yields None)."""

    kind = "avg"
    track_n = True

    def result(self, state, node, g):
        r = _VecSum.result(self, state, node, g)
        if r is ERROR:
            return ERROR
        nnum = state["n"]
        n = nnum[g] if g < len(nnum) else 0
        if n == 0:
            return None
        return r / n


class _VecAny:
    """any: arrival-order extremum — the live row with the smallest
    (time, seq), exactly the classic `_OrderAcc(latest=False)`: a lazy
    heap of ((t, s), gen, value, row_key) per group plus a row_key->gen
    live dict with threshold compaction.  Value-agnostic: Error values
    are stored and returned like any other (classic parity), and heap
    order never compares values ((t, s) is unique per insert)."""

    kind = "any"
    needs_col = True
    needs_seq = True

    def state_init(self):
        return {"heaps": [], "live": [], "gen": []}

    def apply_batch(self, state, codes, n_groups, col, signs, keys, time, seqs):
        heaps, lives, gens = state["heaps"], state["live"], state["gen"]
        while len(heaps) < n_groups:
            heaps.append([])
            lives.append({})
            gens.append(0)
        push = heapq.heappush
        for i in range(len(col)):
            g = codes[i]
            key = keys[i]
            if signs[i] > 0:
                gens[g] += 1
                lives[g][key] = gens[g]
                push(heaps[g], ((time, seqs[i]), gens[g], col[i], key))
            else:
                live = lives[g]
                live.pop(key, None)
                heap = heaps[g]
                if len(heap) > 2 * len(live) + 16:
                    live_get = live.get
                    heaps[g] = [nd for nd in heap if live_get(nd[3]) == nd[1]]
                    heapq.heapify(heaps[g])

    def result(self, state, node, g):
        heaps, lives = state["heaps"], state["live"]
        if g >= len(heaps):
            return None
        heap = heaps[g]
        live_get = lives[g].get
        while heap:
            _k, gen, v, row_key = heap[0]
            if live_get(row_key) != gen:
                heapq.heappop(heap)
                continue
            return v
        return None


class _VecExtremum:
    """min/max: per-group multiplicity bags + cached extremum with lazy
    rescan on retraction of the extremum (O(distinct values), rare)."""

    needs_col = True
    needs_seq = False

    def __init__(self, mode: str):
        self.mode = mode
        self.kind = mode

    def state_init(self):
        return {"bags": [], "cur": [], "dirty": set(), "err": []}

    def apply_batch(self, state, codes, n_groups, col, signs, keys, time, seqs):
        bags, cur, dirty, err = (
            state["bags"], state["cur"], state["dirty"], state["err"],
        )
        while len(bags) < n_groups:
            bags.append({})
            cur.append(None)
            err.append(0)
        is_max = self.mode == "max"
        for i in range(len(col)):
            v = col[i]
            g = codes[i]
            s = signs[i]
            if isinstance(v, Error):
                err[g] += s
                continue
            bag = bags[g]
            m = bag.get(v, 0) + s
            if m:
                bag[v] = m
            else:
                del bag[v]
            if s > 0:
                c = cur[g]
                if c is None or (v > c if is_max else v < c):
                    cur[g] = v
            elif v == cur[g] and v not in bag:
                dirty.add(g)

    def result(self, state, node, g):
        err = state["err"]
        if g < len(err) and err[g]:
            return ERROR
        bag = state["bags"][g]
        if not bag:
            return ERROR  # all-Error group was caught above; defensive
        if g in state["dirty"]:
            state["cur"][g] = max(bag) if self.mode == "max" else min(bag)
            state["dirty"].discard(g)
        return state["cur"][g]


def make_vector_reducer(name: str, arg_kind: str = "i", optional: bool = False):
    if name == "count":
        return _VecCount()
    if name == "sum":
        return _VecSum(arg_kind, optional)
    if name == "avg":
        return _VecAvg(arg_kind, optional)
    if name == "any":
        return _VecAny()
    if name in ("min", "max"):
        return _VecExtremum(name)
    return None


class VectorReduceNode(Node):
    """Columnar groupby-reduce (module docstring).  Bucket-free: group
    keys and reducer args of a retraction are recomputed from the
    retraction row itself, and `live` (row key -> group index) mirrors
    the classic node's ignore-absent-retraction behavior."""

    name = "reduce"
    path = "columnar"
    snapshot_attrs = (
        "gid", "gkeys", "gvals_list", "code_cache", "live", "_live_log",
        "nlive_list", "red_states", "emitted", "_seq",
    )

    def __init__(
        self,
        engine: Engine,
        input_: Node,
        group_fn: Callable,
        reducers: List[Any],
        arg_col_fns: List[Optional[Callable]],
        *,
        gval_width: int,
        group_col_progs: Optional[List[Callable]] = None,
        arg_kinds: Optional[List[str]] = None,
        arg_optionals: Optional[List[bool]] = None,
    ):
        from pathway_tpu_torch.engine.exchange import exchange_by_value

        input_ = exchange_by_value(
            engine, input_,
            lambda keys, rows: [gk for gk, _ in group_fn(keys, rows)],
        )
        super().__init__(engine, [input_])
        self.group_fn = group_fn
        self.reducers = reducers
        # per reducer: fn(keys, rows) -> bare column list, or None (count)
        self.arg_col_fns = arg_col_fns
        self.gval_width = gval_width
        # raw group-column programs enable the fused value->code lookup
        # (one dict get per row); None falls back to group_fn pairs
        self.group_col_progs = group_col_progs
        kinds = arg_kinds or ["i"] * len(reducers)
        opts = arg_optionals or [False] * len(reducers)
        self.vecs = [
            make_vector_reducer(r.name, k, o)
            for r, k, o in zip(reducers, kinds, opts)
        ]
        assert all(v is not None for v in self.vecs)
        # arrival-order reducers (`any`) need the classic node's global
        # insert sequence; only pay for it when one is present
        self._needs_seq = any(v.needs_seq for v in self.vecs)
        self._seq = 0
        self.gid: Dict[Pointer, int] = {}
        self.gkeys: List[Pointer] = []
        self.gvals_list: List[tuple] = []
        self.code_cache: Dict[Any, int] = {}  # raw group value -> index
        # membership is lazy: insert-only streams (the bulk-ingest shape)
        # never pay the per-row dict insert — batches log (keys, codes)
        # pairs, and the dict materializes on the first retraction
        self.live: Dict[Pointer, int] = {}
        self._live_log: List[tuple] = []  # [(keys list, codes array), ...]
        self.nlive_list: np.ndarray = np.zeros(0, dtype=np.int64)
        self.red_states: List[Any] = [v.state_init() for v in self.vecs]
        self.emitted: List[Optional[tuple]] = []

    def _materialize_live(self) -> Dict[Pointer, int]:
        live = self.live
        if self._live_log:
            for keys, codes in self._live_log:
                live.update(zip(keys, codes))
            self._live_log.clear()
        return live

    def _grow(self, n_groups: int) -> None:
        cur = len(self.nlive_list)
        if n_groups > cur:
            grown = np.zeros(max(n_groups, cur * 2, 1024), dtype=np.int64)
            grown[:cur] = self.nlive_list
            self.nlive_list = grown
        emitted = self.emitted
        while len(emitted) < n_groups:
            emitted.append(None)

    def _new_group(self, gkey: Pointer, gvals: tuple) -> int:
        g = len(self.gkeys)
        self.gid[gkey] = g
        self.gkeys.append(gkey)
        self.gvals_list.append(gvals)
        return g

    def _resolve_miss(self, v, single: bool) -> Optional[int]:
        """Slow lane for a cache-missing group value: Error check, key
        derivation, group allocation, cache fill.  None = row dropped."""
        from pathway_tpu_torch.engine.value import ref_scalar

        gvals = (v,) if single else v
        if isinstance(v, Error) or (
            not single and any(isinstance(x, Error) for x in gvals)
        ):
            self.log_error("Error value in groupby key")
            return None
        gkey = ref_scalar(*gvals)
        g = self.gid.get(gkey)
        if g is None:
            g = self._new_group(gkey, gvals)
        try:
            if len(self.code_cache) < (1 << 20):
                self.code_cache[v] = g
        except TypeError:
            pass  # unhashable group value: resolved via gid every batch
        return g

    def _map_fused(self, keys, rows, deltas, n):
        """Raw group value -> dense group index, one dict get per row.
        Returns (codes int64 array, signs int64 array, kept_idx|None)."""
        progs = self.group_col_progs
        cols = [p(keys, rows) for p in progs]
        single = len(cols) == 1
        vals = cols[0] if single else list(zip(*cols))
        code_get = self.code_cache.get

        try:
            codes_list = [code_get(v) for v in vals]
        except TypeError:
            codes_list = []
            for v in vals:
                try:
                    codes_list.append(code_get(v))
                except TypeError:
                    codes_list.append(None)
        drop: Optional[List[int]] = None
        if None in codes_list:
            for i, g in enumerate(codes_list):
                if g is None:
                    v = vals[i]
                    # an earlier miss in this batch may have cached it —
                    # only the first occurrence pays the key derivation
                    try:
                        g = code_get(v)
                    except TypeError:
                        g = None
                    if g is None:
                        g = self._resolve_miss(v, single)
                    if g is None:
                        if drop is None:
                            drop = []
                        drop.append(i)
                        codes_list[i] = -1
                    else:
                        codes_list[i] = g

        all_insert = True
        for d in deltas:
            if d[2] <= 0:
                all_insert = False
                break
        if all_insert and drop is None:
            # bulk-ingest shape: defer membership — log the batch and
            # only materialize the dict if a retraction ever arrives
            codes = np.asarray(codes_list, dtype=np.int64)
            self._live_log.append((keys, codes))
            return codes, np.ones(n, dtype=np.int64), None
        # mixed batch: per-row membership bookkeeping
        live = self._materialize_live()
        live_get = live.get
        signs_list = [1] * n
        for i in range(n):
            if drop is not None and codes_list[i] == -1:
                continue
            key = keys[i]
            g = codes_list[i]
            if deltas[i][2] > 0:
                live[key] = g
            else:
                if live_get(key) != g:
                    # absent (or moved-group) retraction: ignored, matching
                    # the classic node's bucket.pop(key, None) behavior
                    if drop is None:
                        drop = []
                    drop.append(i)
                    codes_list[i] = -1
                    continue
                del live[key]
                signs_list[i] = -1
        codes = np.asarray(codes_list, dtype=np.int64)
        signs = np.asarray(signs_list, dtype=np.int64)
        if drop is not None:
            keep = codes >= 0
            kept_idx = np.nonzero(keep)[0]
            return codes[keep], signs[keep], kept_idx
        return codes, signs, None

    def _map_generic(self, keys, rows, deltas, n):
        """group_fn pair path: instances / custom grouping shapes."""
        gks = self.group_fn(keys, rows)
        gid = self.gid
        gid_get = gid.get
        live = self._materialize_live()
        live_get = live.get
        codes_list = [0] * n
        signs_list = [1] * n
        drop: Optional[List[int]] = None
        for i in range(n):
            gk, gv = gks[i]
            if isinstance(gk, Error):
                self.log_error("Error value in groupby key")
                if drop is None:
                    drop = []
                drop.append(i)
                codes_list[i] = -1
                continue
            key = keys[i]
            if deltas[i][2] > 0:
                g = gid_get(gk)
                if g is None:
                    g = self._new_group(gk, gv)
                live[key] = g
                codes_list[i] = g
            else:
                g = gid_get(gk)
                if g is None or live_get(key) != g:
                    if drop is None:
                        drop = []
                    drop.append(i)
                    codes_list[i] = -1
                    continue
                del live[key]
                codes_list[i] = g
                signs_list[i] = -1
        codes = np.asarray(codes_list, dtype=np.int64)
        signs = np.asarray(signs_list, dtype=np.int64)
        if drop is not None:
            keep = codes >= 0
            kept_idx = np.nonzero(keep)[0]
            return codes[keep], signs[keep], kept_idx
        return codes, signs, None

    def process(self, time: int) -> None:
        deltas = self.take(0)
        if not deltas:
            return
        n = len(deltas)
        self.rows_processed += n
        self.batches_processed += 1
        keys = [d[0] for d in deltas]
        rows = ([d[1] for d in deltas],)

        if self.group_col_progs is not None:
            codes, signs, kept_idx = self._map_fused(keys, rows, deltas, n)
        else:
            codes, signs, kept_idx = self._map_generic(keys, rows, deltas, n)
        gkeys = self.gkeys
        gvals_list = self.gvals_list
        if len(codes) == 0:
            return
        n_groups = len(gkeys)
        self._grow(n_groups)
        # one unweighted bincount doubles as the affected-group set; the
        # weighted one is the per-group live-count delta (both beat
        # np.add.at's per-element dispatch by ~50x)
        occur = np.bincount(codes, minlength=n_groups)
        net = np.bincount(codes, weights=signs, minlength=n_groups)
        self.nlive_list[:n_groups] += net.astype(np.int64)

        kept_keys = None
        seqs = None
        if self._needs_seq:
            kept_keys = (
                keys if kept_idx is None else [keys[i] for i in kept_idx]
            )
            # classic-node parity: one global counter, bumped once per
            # kept insert row in batch order (retractions carry no seq)
            seqs = np.zeros(len(codes), dtype=np.int64)
            sq = self._seq
            for i in range(len(codes)):
                if signs[i] > 0:
                    sq += 1
                    seqs[i] = sq
            self._seq = sq

        for r_idx, vec in enumerate(self.vecs):
            if not vec.needs_col:
                continue
            col = self.arg_col_fns[r_idx](keys, rows)
            if kept_idx is not None:
                col = [col[i] for i in kept_idx]
            vec.apply_batch(
                self.red_states[r_idx], codes, n_groups, col, signs,
                kept_keys, time, seqs,
            )

        affected = np.nonzero(occur)[0].tolist()
        contrib = None
        if _provenance.ACTIVE:
            # lineage: the input delta keys that touched each group this
            # batch (classic ReduceNode parity — see record_reduce)
            ck = keys if kept_idx is None else [keys[i] for i in kept_idx]
            contrib = {}
            for i in range(len(codes)):
                contrib.setdefault(
                    _provenance.key_str(gkeys[int(codes[i])]), []
                ).append(ck[i])
        out: List[Delta] = []
        out_append = out.append
        emitted = self.emitted
        nlive = self.nlive_list
        red_states = self.red_states
        vecs = self.vecs
        if len(vecs) == 1:
            # single-reducer specialization: no per-group genexpr, and the
            # changed-check compares only the result scalar (gvals are
            # fixed per group by construction)
            vec0 = vecs[0]
            state0 = red_states[0]
            result0 = vec0.result
            for g in affected:
                old = emitted[g]
                if nlive[g] > 0:
                    r = result0(state0, self, g)
                    if old is not None:
                        o = old[-1]
                        try:
                            if o is r or o == r or (o != o and r != r):
                                continue  # unchanged (NaN counts as equal)
                        except (TypeError, ValueError):
                            pass
                        out_append((gkeys[g], old, -1))
                    new = gvals_list[g] + (r,)
                    out_append((gkeys[g], new, 1))
                    emitted[g] = new
                elif old is not None:
                    out_append((gkeys[g], old, -1))
                    emitted[g] = None
            if contrib is not None:
                _provenance.tracker().record_reduce(self, time, out, contrib)
            self.emit_consolidated(time, out)
            return
        for g in affected:
            old = emitted[g]
            if nlive[g] > 0:
                results = tuple(
                    vec.result(red_states[r_idx], self, g)
                    for r_idx, vec in enumerate(vecs)
                )
                new = gvals_list[g] + results
                if old is not None:
                    if values_equal_tuple(old, new):
                        continue
                    out_append((gkeys[g], old, -1))
                out_append((gkeys[g], new, 1))
                emitted[g] = new
            elif old is not None:
                out_append((gkeys[g], old, -1))
                emitted[g] = None
        if contrib is not None:
            _provenance.tracker().record_reduce(self, time, out, contrib)
        # per-group retract-before-insert pairs are already minimal and
        # per-key ordered: skip the consolidation pass
        self.emit_consolidated(time, out)
