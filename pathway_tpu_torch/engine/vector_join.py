"""Columnar delta execution for equi-joins (VERDICT weakness #2).

`VectorJoinNode` keeps the exact emit contract of the classic
:class:`~pathway_tpu_torch.engine.operators.JoinNode` — same output keys
(``ref_scalar(lk, rk)`` / side ids), same row tuples, same error logs —
but restructures the per-batch work column-wise, in the spirit of
``vector_reduce.VectorReduceNode``:

* join values for a whole delta batch come from one batched key-program
  evaluation (``_jvs_of``, shared with the classic node),
* each distinct join value maps to a dense int code via one dict lookup
  per row (``jv_code``); per-code buckets are plain insertion-ordered
  dicts, so match iteration order is identical to the classic node's,
* match expansion fills five flat parallel columns (tuple repeats and
  dict-view extends — C loops), and the entire output assembly — the
  blake2b pair key that dominates the classic node's cost, the Pointer
  object, the ``(lk, rk, *lrow, *rrow)`` row tuple and the delta triple
  — happens in ONE native call per batch
  (``value.join_triples_batch`` -> ``wire_ext.make_join_triples``).

Selection happens at graph build time (`internals/joins.py`): the
columnar node is only picked when every join-condition expression has a
statically hashable scalar dtype, so the dict-code path can never meet
an unhashable join value at runtime (and ``_freeze`` is the identity
for those dtypes, so skipping it cannot change match semantics).
Everything else (Json, arrays, tuples, ANY) keeps the classic
row-by-row node.

Two execution modes mirror the classic node exactly:

* **delta mode** (inner join, id_mode='both'): bilinear ΔL⋈R_old then
  L_new⋈ΔR. Matches for a side's deltas are accumulated against the
  other side's index while own-index updates are applied in stream
  order — the same interleaving the classic ``_delta_side`` performs,
  because the other side's index is never mutated during a side's pass.
  Pure-insert batches (the bulk-ingest shape) are provably already
  consolidated (ΔL only meets R_old, ΔR meets L_new, so no pair repeats
  and there is nothing to cancel) and skip the consolidation sort.
* **general mode** (outer joins, id=left/right): affected-code
  recomputation diffed against the emitted cache, with all hash-pair
  output ids of the batch computed in one native call.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Set

from pathway_tpu_torch.engine.operators import JoinNode, _DiffCache
from pathway_tpu_torch.engine.stream import Delta
from pathway_tpu_torch.engine.value import (
    Error,
    Pointer,
    join_delta_side_native,
    join_triples_batch,
    pair_keys_from_pointers,
)
from pathway_tpu_torch.internals import provenance as _provenance

# Flip to force the classic JoinNode everywhere (tests / A-B benches).
VECTOR_JOIN_ENABLED = True


def vector_join_supported() -> bool:
    """Build-time switch: module flag + env escape hatch."""
    return VECTOR_JOIN_ENABLED and not os.environ.get(
        "PATHWAY_DISABLE_VECTOR_JOIN"
    )


class VectorJoinNode(JoinNode):
    """Columnar equi-join over statically hashable join keys.

    State layout (vs the classic jv-keyed nested dicts):

    - ``jv_code``: join value -> dense int code (shared by both sides)
    - ``left_rows[code]`` / ``right_rows[code]``: row_key -> row tuple
      (insertion-ordered, like the classic buckets)
    """

    name = "join"
    path = "columnar"
    snapshot_attrs = ("jv_code", "left_rows", "right_rows", "cache")

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.jv_code: Dict[Any, int] = {}
        self.left_rows: List[Dict[Pointer, tuple]] = []
        self.right_rows: List[Dict[Pointer, tuple]] = []
        self.cache = _DiffCache()  # keyed by code in this node

    def _new_code(self, jv: Any) -> int:
        code = len(self.left_rows)
        self.jv_code[jv] = code
        self.left_rows.append({})
        self.right_rows.append({})
        return code

    # -- delta mode (inner + hash-pair ids) -------------------------------

    def _delta_side_vec(self, deltas, jvs, left_side: bool, acc) -> bool:
        """Match one side's deltas against the other side's index and
        apply them to the own index in stream order. Appends per-pair
        columns to ``acc``; returns True if any retraction was seen."""
        if left_side:
            own_rows, other_rows = self.left_rows, self.right_rows
        else:
            own_rows, other_rows = self.right_rows, self.left_rows
        s_k, s_row, o_k, o_row, dd = acc
        s_k_app = s_k.append
        s_row_app = s_row.append
        dd_app = dd.append
        o_k_ext = o_k.extend
        o_row_ext = o_row.extend
        get_code = self.jv_code.get
        saw_retract = False
        for (key, row, diff), jv in zip(deltas, jvs):
            code = get_code(jv)
            if code is None:
                if isinstance(jv, Error):
                    self.log_error("Error value in join condition")
                    continue
                code = self._new_code(jv)
            orows = other_rows[code]
            if orows:
                m = len(orows)
                o_k_ext(orows)
                o_row_ext(orows.values())
                if m == 1:
                    s_k_app(key)
                    s_row_app(row)
                    dd_app(diff)
                else:
                    s_k.extend((key,) * m)
                    s_row.extend((row,) * m)
                    dd.extend((diff,) * m)
            if diff > 0:
                own_rows[code][key] = row
            else:
                saw_retract = True
                own_rows[code].pop(key, None)
        return saw_retract

    def _process_delta(self, left_deltas, right_deltas, time: int) -> None:
        left_jvs = self._jvs_of(left_deltas, self.left_key_fn)
        right_jvs = self._jvs_of(right_deltas, self.right_key_fn)
        fused = join_delta_side_native()
        if fused is not None:
            out: list = []
            retract = 0
            errors = 0
            if left_deltas:
                r, e = fused(
                    self.jv_code, left_jvs, left_deltas,
                    self.left_rows, self.right_rows, 1, Error, out,
                )
                retract |= r
                errors += e
            if right_deltas:
                r, e = fused(
                    self.jv_code, right_jvs, right_deltas,
                    self.left_rows, self.right_rows, 0, Error, out,
                )
                retract |= r
                errors += e
            for _ in range(errors):
                self.log_error("Error value in join condition")
        else:
            # (self keys, self rows, other keys, other rows, diffs)
            acc_l = ([], [], [], [], [])
            acc_r = ([], [], [], [], [])
            retract = self._delta_side_vec(left_deltas, left_jvs, True, acc_l)
            retract |= self._delta_side_vec(
                right_deltas, right_jvs, False, acc_r
            )
            lk = acc_l[0] + acc_r[2]
            rk = acc_l[2] + acc_r[0]
            lrow = acc_l[1] + acc_r[3]
            rrow = acc_l[3] + acc_r[1]
            diffs = acc_l[4] + acc_r[4]
            out = join_triples_batch(lk, rk, lrow, rrow, diffs)
        if not out:
            return
        if _provenance.ACTIVE:
            _provenance.tracker().record_join(self, time, out)
        if retract:
            # retractions can cancel against same-batch insertions of the
            # same pair; route through the consolidating emit like the
            # classic node
            self.emit(time, out)
        else:
            self.emit_consolidated(time, out)

    # -- general mode (outer joins, id=left/right) ------------------------

    def _apply_side_vec(self, deltas, jvs, left_side: bool, affected: Set[int]):
        rows_l = self.left_rows if left_side else self.right_rows
        get_code = self.jv_code.get
        for (key, values, diff), jv in zip(deltas, jvs):
            code = get_code(jv)
            if code is None:
                if isinstance(jv, Error):
                    self.log_error("Error value in join condition")
                    continue
                code = self._new_code(jv)
            affected.add(code)
            if diff > 0:
                rows_l[code][key] = values
            else:
                rows_l[code].pop(key, None)

    def process(self, time: int) -> None:
        left_deltas = self.take(0)
        right_deltas = self.take(1)
        if not left_deltas and not right_deltas:
            return
        self.rows_processed += len(left_deltas) + len(right_deltas)
        self.batches_processed += 1
        if self._delta_mode:
            self._process_delta(left_deltas, right_deltas, time)
            return
        affected: Set[int] = set()
        left_jvs = self._jvs_of(left_deltas, self.left_key_fn)
        right_jvs = self._jvs_of(right_deltas, self.right_key_fn)
        self._apply_side_vec(left_deltas, left_jvs, True, affected)
        self._apply_side_vec(right_deltas, right_jvs, False, affected)
        out: List[Delta] = []
        l_nones = (None,) * self.left_width
        r_nones = (None,) * self.right_width
        hash_ids = self.id_mode == "both"
        # stage 1: plan per-code work, gathering every hash-pair output id
        # of the batch into two flat Pointer lists for one native call
        plan = []
        pair_l: List[Pointer] = []
        pair_r: List[Pointer] = []
        for code in affected:
            lefts = self.left_rows[code]
            rights = self.right_rows[code]
            if lefts and rights:
                if hash_ids:
                    rk_tup = tuple(rights)
                    nr = len(rk_tup)
                    for lkey in lefts:
                        if nr == 1:
                            pair_l.append(lkey)
                        else:
                            pair_l.extend((lkey,) * nr)
                    pair_r.extend(rk_tup * len(lefts))
                plan.append((code, "m", lefts, rights))
            elif lefts and self.left_outer:
                plan.append((code, "l", lefts, None))
            elif rights and self.right_outer:
                plan.append((code, "r", None, rights))
            else:
                plan.append((code, "e", None, None))
        pair_ptrs = (
            pair_keys_from_pointers(pair_l, pair_r) if pair_l else []
        )
        # stage 2: per-code recompute + diff against the emitted cache,
        # identical row/dup-id semantics to the classic general path
        pos = 0
        for code, kind, lefts, rights in plan:
            new_rows: Dict[Pointer, tuple] = {}
            if kind == "m":
                for lkey, lrow in lefts.items():
                    for rkey, rrow in rights.items():
                        if hash_ids:
                            out_id = pair_ptrs[pos]
                            pos += 1
                        else:
                            out_id = self._out_id(lkey, rkey)
                        if out_id in new_rows:
                            self.log_error(
                                f"join: duplicate row id {out_id!r} "
                                "(id= side matches multiple rows)"
                            )
                            continue
                        new_rows[out_id] = (lkey, rkey, *lrow, *rrow)
            elif kind == "l":
                for lkey, lrow in lefts.items():
                    new_rows[self._out_id(lkey, None)] = (
                        lkey, None, *lrow, *r_nones
                    )
            elif kind == "r":
                for rkey, rrow in rights.items():
                    new_rows[self._out_id(None, rkey)] = (
                        None, rkey, *l_nones, *rrow
                    )
            self.cache.diff(code, new_rows, out)
        if _provenance.ACTIVE:
            _provenance.tracker().record_join(self, time, out)
        self.emit(time, out)
