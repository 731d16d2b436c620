"""Wave-batched query executor: the engine's performance path.

The reference overlaps queries with a 2-level thread pool (72 pthreads,
MainScheduler.cpp) — the array analog is *latency batching*: all
device calls are async, so the host drives a whole batch of queries
breadth-first and synchronizes only where a value is genuinely needed:

  readbacks per batch = 1 (flags + spec flags + SUM partials, one sweep)
                      + one stacked readback per residual join wave —
                        and with deferred attaches (any depth) plus
                        speculative expansion sizing, whole queries
                        compile to a SINGLE dispatch and the golden
                        workload runs with zero wave readbacks

versus one readback per operator in the naive executor: every readback
is a host-device round trip that leaves the device idle.
Mis-speculated expansions (device-verified) retry on the exact path;
`counters` tracks dispatches / readbacks / spec retries.

Representation: each query's intermediate is ONE (k, P) int32 device
matrix — row j is the rowid column of the j-th joined slot (vs the
reference's per-slot vectors, intermediate.h) — so every chaining case is
a single fused program (ops/chain.py) and dispatch count stays small.
Counts stay on device; NULL detection defers to a flag readback (filter-
emptied slot, empty pair set of a both-joined step) or falls out of the
join-total readback (cases 1/2). Semantics identical to oracle.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT
from ..ops.aggregate import gather_partials_matrix
from ..ops.backend import JoinBackend
from ..ops.chain import eq_filter_matrix, eq_filter_rows
from ..ops.filter import filter_full, filter_live
from ..ops.join import JoinCapacityError
from ..ops.stage import part_shape, run_stage
from ..ops.terminal import (channel_spec,
                            combine_fresh_partials,
                            combine_fresh_w_partials,
                            terminal_join_and_project)
from ..storage import Relation
from ..utils.limbs import (combine_limb_partials, combine_weighted_partials,
                           combine_weighted_segments)
from ..utils.profiling import OpProfiler
from ..workload import Query
from .device_catalog import DeviceCatalog
from .planner import _propagate_join, _rough_filter_estimate
from .stats import estimate_join_output, seed_stats

_U64_MASK = (1 << 64) - 1

_COMBINERS = {"limb": combine_limb_partials,
              "weighted": combine_weighted_partials,
              "weighted_seg": combine_weighted_segments,
              "fresh": combine_fresh_partials,
              "fresh_w": combine_fresh_w_partials}


@jax.jit
def _assemble_sweep(bools, parts):
    """Pack every NULL/spec flag and folded sum partial of a batch into
    one flat int32 vector — the batch's single device->host readback.
    One trace per distinct batch structure (pytree of scalars + folded
    partial shapes); the golden workload has 5."""
    segs = [jnp.stack(bools).astype(jnp.int32)] if bools else []
    segs += [p.reshape(-1) for p in parts]
    return jnp.concatenate(segs)

# sentinel: a query whose speculative expansion under-sized (device spec
# flag False) — rerun on the exact readback path
_RETRY = object()
_UNPLANNED = object()


class _QState:
    __slots__ = ("q", "live_rows", "live_cnt", "mat", "slot_row", "icount",
                 "null", "flags", "probe", "fresh_slot", "sums", "terminal",
                 "next_join", "pending", "mat_rows", "defers", "spec_flags",
                 "speculate", "est", "flag_refs", "spec_refs",
                 "probe_total_ref")

    def __init__(self, q: Query, speculate: bool = True):
        self.q = q
        self.live_rows: List[jax.Array] = []
        self.live_cnt: List[object] = []      # device int32 or np.int32
        self.mat: Optional[jax.Array] = None  # (k, P) intermediate matrix
        self.slot_row: Dict[int, int] = {}    # slot -> matrix row
        self.icount: object = np.int32(0)
        self.null = False                      # decided on host (join total 0)
        self.flags: List[jax.Array] = []       # device bools, OR'd at the end
        self.probe = None
        self.fresh_slot = None
        # per projection: list of (kind, partials array, plane shift);
        # empty list = never-joined slot (sum 0). Wide (u64) projection
        # columns contribute one entry per 16-bit plane.
        self.sums: List[list] = []
        self.terminal = False                  # last join ran fused+factorized
        # fused-stage bookkeeping (host mirrors of static structure)
        self.next_join = 0
        self.pending = None                    # ("pair", s1, s2)|("attach", f)
        self.mat_rows = 0
        # deferred middle attaches (any number, any depth): each entry is
        # {"slot", "mult_row", "lv_row", "col_join"}; mult/lv are matrix
        # rows that ride along through compactions and expansions
        self.defers: List[dict] = []
        # speculative expansion sizing: device ok-flags; any False => the
        # query retries on the exact readback path
        self.spec_flags: List[jax.Array] = []
        self.speculate = speculate
        self.est = None                        # List[SlotStats] (lazy)
        # fused-path packed-vector references: (vec id, offset) into the
        # round's single int32 output vector (ops/stage.py run_stage)
        self.flag_refs: List[tuple] = []
        self.spec_refs: List[tuple] = []
        self.probe_total_ref = None


class BatchExecutor:
    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT,
                 catalog: Optional[DeviceCatalog] = None):
        self.catalog = catalog or DeviceCatalog(relations, config)
        self.config = config
        self.profiler = OpProfiler(config.profile)
        # dispatch/readback accounting:
        # dispatches = compiled-program launches; readbacks = host syncs
        self.counters = {"dispatches": 0, "readbacks": 0, "spec_retries": 0,
                         "ftree_queries": 0}
        # query-signature -> planned ftree (or None = doesn't factorize);
        # the cols inside are catalog device arrays, alive for the
        # catalog's lifetime
        self._ftree_plans: Dict[tuple, object] = {}
        kind = config.join_backend
        if kind == "auto":
            kind = ("dense" if self.catalog.domain <= config.max_dense_domain
                    else "sort")
        self.join = JoinBackend(kind, self.catalog.domain)

    # ---- phases ----

    def _init_and_filter(self, q: Query) -> _QState:
        cat = self.catalog
        st = _QState(q)
        for s in range(len(q.slots)):
            n = cat.relations[q.slots[s]].num_tuples
            st.live_rows.append(cat.iota(cat.bucket(n)))
            st.live_cnt.append(np.int32(n))
        pristine = set(range(len(q.slots)))
        for f in q.filters:
            col = cat.col(q.slots[f.slot], f.col)
            opc, const = cat.encode_filter(f.op, f.value)
            if f.slot in pristine:
                # first filter on the slot: scan the column directly
                n = cat.relations[q.slots[f.slot]].num_tuples
                rows, cnt = self.profiler.record(
                    "filter",
                    filter_full(col, np.int32(n), const, opc, cat.bucket(n)),
                    (col,))
                pristine.discard(f.slot)
            else:
                rows, cnt = self.profiler.record(
                    "filter",
                    filter_live(st.live_rows[f.slot], st.live_cnt[f.slot],
                                col, const, opc),
                    (st.live_rows[f.slot],))   # col is point-gathered, not scanned
            st.live_rows[f.slot], st.live_cnt[f.slot] = rows, cnt
            st.flags.append(cnt == 0)   # device bool; NULL if ever true
        return st

    def _join_wave_probe(self, st: _QState, k: int) -> bool:
        """Dispatch join k's device work. Returns True if a probe total
        readback is pending (cases 1/2); same-slot and case-3 joins
        complete without any readback."""
        cat = self.catalog
        q = st.q
        j = q.joins[k]
        s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
        colA = cat.col(q.slots[s1], c1)
        colB = cat.col(q.slots[s2], c2)

        if s1 == s2:
            # same-slot predicate: row filter, never NULL (Query.cpp:168-170)
            if s1 not in st.slot_row:
                # fresh slot: creates a singleton intermediate and, like
                # case 1, wipes any other component (oracle.py, §8.2 UB
                # extension)
                rows, cnt = self.profiler.record(
                    "eq_filter",
                    eq_filter_rows(colA, colB, st.live_rows[s1],
                                   st.live_cnt[s1]),
                    (st.live_rows[s1],))
                st.mat = rows[None]
                st.slot_row = {s1: 0}
                st.icount = cnt
            else:
                mat, cnt = self.profiler.record(
                    "eq_filter",
                    eq_filter_matrix(colA, colB, st.mat, st.slot_row[s1],
                                     st.slot_row[s2], st.icount),
                    (st.mat,))
                st.mat, st.icount = mat, cnt
            return False

        j1, j2 = s1 in st.slot_row, s2 in st.slot_row
        if j1 and j2:
            # case 3: row filter; NULL iff pair set empty -> deferred flag
            nonempty = self.join.any_common_matrix(
                colA, colB, st.mat, st.slot_row[s1], st.slot_row[s2],
                st.icount)
            mat, cnt = self.profiler.record(
                "eq_filter",
                eq_filter_matrix(colA, colB, st.mat, st.slot_row[s1],
                                 st.slot_row[s2], st.icount),
                (st.mat,))
            st.mat, st.icount = mat, cnt
            st.flags.append(~nonempty)
            return False

        # factorized terminal join (dense backend): the last join's output
        # is only ever aggregated — ONE fused program computes the dense
        # count probe AND every projection; nothing materializes, no
        # readback; NULL defers to a device flag
        if (k == len(q.joins) - 1 and self.join.kind == "dense"):
            domain = self.catalog.domain
            if not j1 and not j2:
                # case-1 wipe semantics: only s1/s2 survive (SURVEY.md §8.5)
                ex_kind, ex_slot, full_row = "rows", s1, 0
                ex_source = st.live_rows[s1]
                icount = st.live_cnt[s1]
                fresh, col_full, col_fresh = s2, colA, colB
                fresh_col = c2
                st.slot_row = {}
                st.mat = None
            else:
                if j1:
                    full, fresh, col_full, col_fresh = s1, s2, colA, colB
                    fresh_col = c2
                else:
                    full, fresh, col_full, col_fresh = s2, s1, colB, colA
                    fresh_col = c1
                ex_kind, ex_slot, full_row = "mat", None, st.slot_row[full]
                ex_source = st.mat
                icount = st.icount

            fresh_mult = cat.max_mult(q.slots[fresh], fresh_col)
            specs, cols, shifts, plane_n = [], [], [], []
            for p in q.projections:
                if p.slot == fresh:
                    spec = "fresh"
                elif ex_kind == "mat" and p.slot in st.slot_row:
                    spec = ("mat", st.slot_row[p.slot])
                elif ex_kind == "rows" and p.slot == ex_slot:
                    spec = ("rows",)
                else:
                    plane_n.append(0)
                    continue
                planes = cat.proj_planes(q.slots[p.slot], p.col)
                vmaxes = cat.plane_maxes(q.slots[p.slot], p.col)
                plane_n.append(len(planes))
                for (plane, sh), vmax in zip(planes, vmaxes):
                    specs.append(("fresh", channel_spec(fresh_mult, vmax))
                                 if spec == "fresh" else spec)
                    cols.append(plane)
                    shifts.append(sh)

            plan = (ex_kind, full_row, tuple(specs))
            empty, outs = self.profiler.record(
                "terminal",
                terminal_join_and_project(
                    ex_source, icount, st.live_rows[fresh],
                    st.live_cnt[fresh], col_full, col_fresh, tuple(cols),
                    plan, domain),
                (ex_source, st.live_rows[fresh]))
            st.flags.append(empty)
            oi = 0
            for npl in plane_n:
                parts = []
                for _ in range(npl):
                    kind = (("fresh", specs[oi][1])
                            if specs[oi][0] == "fresh" else "weighted")
                    parts.append((kind, outs[oi], shifts[oi]))
                    oi += 1
                st.sums.append(parts)
            st.terminal = True
            return False

        if not j1 and not j2:
            # case 1: probe between live sets
            st.probe = self.profiler.record(
                "probe",
                self.join.probe_rows(colA, st.live_rows[s1],
                                     st.live_cnt[s1], colB,
                                     st.live_rows[s2], st.live_cnt[s2]),
                (st.live_rows[s1], st.live_rows[s2]))
            st.fresh_slot = None
        else:
            # case 2: probe intermediate (full side) against fresh live set
            if j1:
                full, fresh, col_full, col_fresh = s1, s2, colA, colB
            else:
                full, fresh, col_full, col_fresh = s2, s1, colB, colA
            st.probe = self.profiler.record(
                "probe",
                self.join.probe_matrix(col_full, st.mat,
                                       np.int32(st.slot_row[full]),
                                       st.icount, col_fresh,
                                       st.live_rows[fresh],
                                       st.live_cnt[fresh]),
                (st.mat[0], st.live_rows[fresh]))
            st.fresh_slot = fresh
        return True

    def _join_wave_expand(self, st: _QState, k: int, total: int) -> None:
        """Finish join k after its total came back (cases 1/2)."""
        if total < 0:
            raise JoinCapacityError(
                f"join {k} of query exceeds 2**31-1 output pairs")
        if total == 0:
            st.null = True
            return
        j = st.q.joins[k]
        order, lo, off, cum, _ = st.probe
        out_size = self.catalog.bucket(total)
        if st.fresh_slot is None:
            # case 1 discards any other slot's data (quirk SURVEY.md §8.5)
            st.mat = self.profiler.record(
                "expand",
                self.join.expand_fresh_pair(order, lo, off, cum,
                                            st.live_rows[j.slot1],
                                            st.live_rows[j.slot2], out_size),
                (order, lo))
            st.slot_row = {j.slot1: 0, j.slot2: 1}
        else:
            st.mat = self.profiler.record(
                "expand",
                self.join.expand_attach_fresh(
                    order, lo, off, cum, st.mat,
                    st.live_rows[st.fresh_slot], out_size),
                (order, lo, st.mat))
            st.slot_row[st.fresh_slot] = st.mat.shape[0] - 1
        st.icount = np.int32(total)
        st.probe = None

    def _projections(self, st: _QState) -> None:
        if st.terminal:        # sums already produced by the fused program
            return
        cat = self.catalog
        for p in st.q.projections:
            row = st.slot_row.get(p.slot)
            if row is None:
                st.sums.append([])
                continue
            parts = []
            for plane, sh in cat.proj_planes(st.q.slots[p.slot], p.col):
                parts.append(("limb", self.profiler.record(
                    "aggregate",
                    gather_partials_matrix(plane, st.mat, np.int32(row),
                                           st.icount),
                    (st.mat[0],)), sh))
            st.sums.append(parts)

    # ---- speculative expansion sizing (models/stats.py estimator) ----

    def _ensure_est(self, st: _QState) -> None:
        if st.est is None:
            st.est = seed_stats(self.catalog.relations, st.q.slots)
            for f in st.q.filters:
                surviving = _rough_filter_estimate(st.est[f.slot], f.col,
                                                   f.op, f.value)
                st.est[f.slot].apply_filter(f.col, f.op, f.value, surviving)

    def _spec_size(self, st: _QState, j) -> Optional[int]:
        """Padded speculative output size for join j, or None when the
        estimate (x slack) exceeds speculate_max — then the exact
        readback path runs instead."""
        self._ensure_est(st)
        est = estimate_join_output(st.est[j.slot1], j.col1,
                                   st.est[j.slot2], j.col2)
        _propagate_join(st.est, j)
        size = self.catalog.bucket(
            max(int(est * self.config.speculate_slack), 1))
        return size if size <= self.config.speculate_max else None

    # ---- factorized tree planner (ops/factorized.py) ----

    def _extract_tree(self, q: Query):
        """Walk the join sequence with the oracle's exact case semantics
        (SURVEY.md §9). Returns (final_comp, wiped_comps) when the query
        factorizes — every join attaches a fresh slot, OR re-joins
        already-joined slots (case 3) in a way a union-find over
        (slot, col) value-equivalence classes can rewrite away — else
        None.

        Case-3 rewriting (both slots already in the comp): the edge keeps
        rows where col1[r1] == col2[r2]; every prior edge/selection forces
        value equality within its class on all surviving rows, so
          * both cols in one class -> the edge is an identity filter:
            drop it (exact: rows are non-empty here unless the query is
            already NULL, and each surviving row's pair is in the pair
            set, so the join's NULL test cannot fire either);
          * one col's class holds a column of the OTHER col's slot ->
            the condition collapses to a SAME-SLOT selection, recorded
            with born_of_join=True (its pair-set-empty NULL rule differs
            from a native selection's only when trailing — see below);
          * the two slots are joined by an EXISTING DIRECT tree edge
            (a parallel edge over distinct columns) -> FUSE into that
            edge as a composite key (DeviceCatalog.edge_key pair
            dictionary): the fused edge enforces both equalities, and
            predicate order cannot change the final multiset (pure
            conjunction) or the NULL outcome (any step emptying ==
            final multiset empty) — EXCEPT when no join follows the
            fusing predicate, where the reference's trailing rule
            (sums-0-not-NULL iff the step's own pair set is non-empty,
            oracle.py:121-142) differs from root emptiness: that case
            falls back (checked after the walk);
          * otherwise (slots connected only transitively): fall back.

        A comp is {"nodes": slots in attach order (nodes[0] = root),
        "set", "edges": [(p_slot, p_cols, c_slot, c_cols)] in attach
        order with TUPLE column keys (len > 1 == composite/fused edge),
        "sels": [(slot, c1, c2, n_edges_at_append, born_of_join)],
        "trail": None | (slot, c1, c2, born_of_join) — at most one
        selection sitting AFTER the last edge; ops/factorized.py excludes
        it from the NULL flags (a trailing selection may empty the final
        multiset without NULLing, oracle.py:121-124,133-142) and gates
        NULL from the pre-selection rows instead}. Case-1 and fresh
        same-slot predicates WIPE the previous comp (§8.5/§8.2) and reset
        the equivalence classes; wiped comps with joins still gate NULL
        and come back flag-only."""
        comp = None
        wiped = []
        parent: dict = {}            # union-find over (slot, col)
        members: dict = {}           # root -> set of (slot, col)

        def find(x):
            parent.setdefault(x, x)
            r = x
            while parent[r] != r:
                r = parent[r]
            while parent[x] != r:
                parent[x], x = r, parent[x]
            return r

        def union(x, y):
            rx, ry = find(x), find(y)
            if rx == ry:
                return
            parent[ry] = rx
            mx = members.setdefault(rx, {rx})
            mx |= members.pop(ry, {ry})

        def new_comp(s):
            parent.clear()
            members.clear()
            return {"nodes": [s], "set": {s}, "edges": [], "sels": []}

        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            if s1 == s2:
                if comp is not None and s1 in comp["set"]:
                    comp["sels"].append((s1, c1, c2,
                                         len(comp["edges"]), False))
                else:
                    if comp is not None and comp["edges"]:
                        wiped.append(comp)
                    comp = new_comp(s1)
                    comp["sels"].append((s1, c1, c2, 0, False))
                union((s1, c1), (s1, c2))
                continue
            j1 = comp is not None and s1 in comp["set"]
            j2 = comp is not None and s2 in comp["set"]
            if j1 and j2:
                # case 3: rewrite via the value-equivalence classes
                a, b = (s1, c1), (s2, c2)
                ra, rb = find(a), find(b)
                at = len(comp["edges"])
                if ra == rb:
                    # identity — but a selection pending at this exact
                    # position could empty the rows first, and then the
                    # join's pair set IS empty (NULL) while the dropped
                    # edge would never notice: fall back in that case
                    if any(s[3] == at for s in comp["sels"]):
                        return None
                    continue
                # path rewriting through the equivalence classes: every
                # prior edge/selection forces value equality within its
                # class on all surviving (pre-this-predicate) rows, so
                # the predicate a==b may be restated between ANY member
                # of a's class and ANY member of b's class — pick a
                # pairing that lands on one slot (-> same-slot
                # selection) or on a DIRECT tree edge (-> composite-key
                # fusion). This closes the transitive-cycle class the
                # old planner fell back on whenever such a pairing
                # exists; a genuinely cyclic residue (no pairing works,
                # e.g. a triangle over fresh columns) still falls back.
                ma = sorted(members.get(ra, {ra}))
                mb = sorted(members.get(rb, {rb}))
                sel = None
                for (sa, ca) in ma:
                    for (sb, cb) in mb:
                        if sa == sb:
                            sel = (sa, ca, cb)
                            break
                    if sel is not None:
                        break
                if sel is not None:
                    comp["sels"].append((*sel, at, True))
                    union(a, b)
                    continue
                fused = False
                fused_i = -1
                for i, (p, pcs, c, ccs) in enumerate(comp["edges"]):
                    pa = next((cc for (s, cc) in ma if s == p), None)
                    cb = next((cc for (s, cc) in mb if s == c), None)
                    if pa is None or cb is None:
                        # the mirrored orientation: b's class on the
                        # parent, a's class on the child
                        pa = next((cc for (s, cc) in mb if s == p), None)
                        cb = next((cc for (s, cc) in ma if s == c), None)
                    if pa is not None and cb is not None:
                        comp["edges"][i] = (p, pcs + (pa,),
                                            c, ccs + (cb,))
                        fused = True
                        fused_i = i
                        break
                if not fused:
                    return None      # irreducible cycle
                comp.setdefault("fused_at", []).append((at, fused_i))
                union(a, b)
                continue
            if not j1 and not j2:
                if comp is not None and comp["edges"]:
                    wiped.append(comp)
                comp = new_comp(s1)
                comp["nodes"].append(s2)
                comp["set"].add(s2)
                comp["edges"].append((s1, (c1,), s2, (c2,)))
            else:
                p, pc, ch, cc = (s1, c1, s2, c2) if j1 else (s2, c2, s1, c1)
                comp["nodes"].append(ch)
                comp["set"].add(ch)
                comp["edges"].append((p, (pc,), ch, (cc,)))
            union((s1, c1), (s2, c2))
        if comp is None or not comp["edges"]:
            return None
        # selections AFTER the last join make the final multiset differ
        # from the last join's output; ops/factorized.py handles ONE via
        # the trailing-selection machinery (pre-selection NULL gating).
        # MULTIPLE trailing selections ride as pure msg_mask entries
        # (comp["tsels"]) on a root-flag-suppressed sums spec, with a
        # trailing-free boolean companion spec carrying the NULL gate
        # (_ftree_plan_for "masked"/"pregate"). A join-born trailing
        # selection carries the reference's step-pair-set NULL rule,
        # which evaluates on the state BEFORE any later trailing entry —
        # sound only when it is FIRST among them (companion part test =
        # pre-trailing state): any other arrangement falls back.
        ne = len(comp["edges"])
        # a TRAILING fusion (no edge appended after it) carries the
        # reference's step-pair-set NULL rule, which differs from the
        # fused tree's root emptiness (sums-0-not-NULL): plan a boolean
        # companion spec of the PRE-fusion tree with a cross-node
        # support-intersection gate (ops/factorized.py trail 4-tuple).
        # At most ONE, and nothing else at the same position (the sels
        # list loses the relative order of same-position predicates,
        # which decides the gate's pre-state): else fall back.
        for w in [comp] + wiped:
            tf = [ei for (a, ei) in w.get("fused_at", ())
                  if a == len(w["edges"])]
            if len(tf) > 1:
                return None
            if tf and any(s[3] == len(w["edges"]) for s in w["sels"]):
                return None
            w["trail_fuse"] = tf[0] if tf else None
        trailing = [s for s in comp["sels"] if s[3] == ne]
        if any(s[4] for s in trailing[1:]):
            return None          # join-born entry not first among trailing
        comp["trail"] = ((trailing[0][0], trailing[0][1], trailing[0][2],
                          trailing[0][4]) if trailing else None)
        comp["tsels"] = [(s[0], s[1], s[2]) for s in trailing[1:]]
        comp["sels"] = [s for s in comp["sels"] if s[3] < ne]
        for w in wiped:
            # trailing entries in a WIPED comp: natives cannot NULL and
            # the case-1 wipe discards their rows — drop them; ONE
            # join-born entry (necessarily first, else fall back: its
            # pair set evaluates before any later trailing mask) still
            # carries the step-pair-set NULL test via the flag-only gate
            wne = len(w["edges"])
            wt = [s for s in w["sels"] if s[3] >= wne]
            if any(s[4] for s in wt[1:]):
                return None
            w["trail"] = ((wt[0][0], wt[0][1], wt[0][2], True)
                          if wt and wt[0][4] else None)
            w["tsels"] = []
            w["sels"] = [s for s in w["sels"] if s[3] < wne]
        return comp, wiped

    _CAP = 2**31

    def _ftree_caps(self, q: Query, comp, proj_slots) -> bool:
        """Exact host-side overflow caps: every message-table entry and
        per-row weight the factorized pass computes must stay < 2**31 in
        int32. Derived from load-time max multiplicities (filters and
        selections only shrink them)."""
        cat = self.catalog
        edges = comp["edges"]
        capB = [0] * len(edges)
        capbeta = {}
        for i in range(len(edges) - 1, -1, -1):
            p, pcs, c, ccs = edges[i]
            n_c = max(cat.relations[q.slots[c]].num_tuples, 1)
            mult_c = cat.edge_key_max_mult(q.slots[p], pcs, q.slots[c],
                                           ccs, "c")
            cb = min(mult_c, n_c) * capbeta.get(c, 1)
            if cb >= self._CAP:
                return False
            capB[i] = cb
            capbeta[p] = capbeta.get(p, 1) * cb
            if capbeta[p] >= self._CAP:
                return False
        child_edges = {}
        for i, (p, *_r) in enumerate(edges):
            child_edges.setdefault(p, []).append(i)
        capalpha = {comp["nodes"][0]: 1}
        for i, (p, pcs, c, ccs) in enumerate(edges):
            excl = capalpha[p]
            for j in child_edges[p]:
                if j != i:
                    excl *= capB[j]
            if excl >= self._CAP:
                return False
            n_p = max(cat.relations[q.slots[p]].num_tuples, 1)
            mult_p = cat.edge_key_max_mult(q.slots[p], pcs, q.slots[c],
                                           ccs, "p")
            ca = min(mult_p, n_p) * excl
            if ca >= self._CAP:
                return False
            capalpha[c] = ca
        for s in proj_slots:
            if capalpha.get(s, 1) * capbeta.get(s, 1) >= self._CAP:
                return False
        return True

    def _plan_ftree(self, q: Query, comp, sum_map, with_projs: bool,
                    variant=None):
        """Emit one ("ftree", spec, n_cols, n_vals) op (+ cols/vals) for
        a comp. The final comp (with_projs) also carries every filtered
        slot OUTSIDE the tree as a standalone flag-only node — a filter
        emptying ANY slot NULLs the query (Query.cpp:95-146). Column and
        value order MUST match ops/factorized.py's consumption order.

        variant (comps with a TRAILING fusion, comp["trail_fuse"]):
          "fused": the tree as fused — sums are exact on it, but its
                   root-emptiness flag is SUPPRESSED (a trailing case-3
                   may empty the multiset without NULLing);
          "gate":  the PRE-fusion tree (the trailing pair stripped from
                   the fused edge), flag-only, with a cross-node
                   support-intersection gate deciding NULL via the
                   reference's step pair-set rule (oracle.py:133-142,
                   /root/reference/Query.cpp:188-191).

        variant (comps with MULTIPLE trailing selections, comp["tsels"]):
          "masked":  the sums spec — every trailing selection rides as a
                     pure msg_mask entry (spec tsels), root flag
                     SUPPRESSED (trailing masks on other nodes leak into
                     any node's alpha/beta, so no single-node test on
                     this spec can see the pre-trailing state);
          "pregate": the trailing-free boolean companion carrying the
                     NULL gate — the root M flag (all trailing entries
                     native: NULL iff some join emptied == pre-trailing
                     multiset empty) or the join-born pair-set gate
                     (a born entry is required to be FIRST among the
                     trailing entries, so its pre-state IS the
                     pre-trailing state)."""
        cat = self.catalog
        edges_src = comp["edges"]
        gate_pair = None
        if variant == "gate":
            gi = comp["trail_fuse"]
            gp, gpcs, gc, gccs = edges_src[gi]
            edges_src = list(edges_src)
            edges_src[gi] = (gp, gpcs[:-1], gc, gccs[:-1])
            gate_pair = (gp, gpcs[-1], gc, gccs[-1])
        nodes = list(comp["nodes"])
        if with_projs:
            nodes += sorted({f.slot for f in q.filters}
                            - comp["set"])
        idx_of = {s: i for i, s in enumerate(nodes)}
        filts_by = {i: [] for i in range(len(nodes))}
        for f in q.filters:
            if f.slot in idx_of:
                filts_by[idx_of[f.slot]].append(f)
        sels_by = {i: [] for i in range(len(nodes))}
        for (s, c1, c2, _at, _born) in comp["sels"]:
            sels_by[idx_of[s]].append((c1, c2))
        cols, vals = [], []
        filt_ops = []
        for i, s in enumerate(nodes):
            ops = []
            for f in filts_by[i]:
                opc, const = cat.encode_filter(f.op, f.value)
                ops.append(opc)
                cols.append(cat.col(q.slots[s], f.col))
                vals.append(cat.scalar(int(const)))
            filt_ops.append(tuple(ops))
            for (c1, c2) in sels_by[i]:
                cols.append(cat.col(q.slots[s], c1))
                cols.append(cat.col(q.slots[s], c2))
        def _width(*col_maxes: int) -> int:
            """Smallest power of two spanning every listed code max —
            the edge's message-table width (covers both scatter and
            gather key ranges, so no index can leave the table)."""
            w = 8
            need = max(col_maxes) + 1
            while w < need:
                w *= 2
            return w

        trail = comp.get("trail")
        tsels_use = []
        if variant == "masked":
            tsels_use = ([(trail[0], trail[1], trail[2])] if trail
                         else []) + list(comp.get("tsels") or ())
            trail = None
        elif variant == "pregate":
            trail = trail if (trail is not None and trail[3]) else None
        elif comp.get("tsels"):
            # a comp with multiple trailing selections only ever plans
            # through the masked/pregate pair
            raise AssertionError("tsels comp planned without variant")
        trail_spec = None
        if gate_pair is not None:
            gp, gpc, gc, gcc = gate_pair
            trail_spec = (idx_of[gp], True,
                          _width(cat.code_max(q.slots[gp], gpc),
                                 cat.code_max(q.slots[gc], gcc)),
                          idx_of[gc])
            cols.append(cat.col(q.slots[gp], gpc))
            cols.append(cat.col(q.slots[gc], gcc))
        elif trail is not None:
            ts, tc1, tc2, tborn = trail
            trail_spec = (idx_of[ts], tborn,
                          _width(cat.code_max(q.slots[ts], tc1),
                                 cat.code_max(q.slots[ts], tc2)))
            cols.append(cat.col(q.slots[ts], tc1))
            cols.append(cat.col(q.slots[ts], tc2))
        tsels_spec = []
        for (ts, tc1, tc2) in tsels_use:
            tsels_spec.append(idx_of[ts])
            cols.append(cat.col(q.slots[ts], tc1))
            cols.append(cat.col(q.slots[ts], tc2))
        edges_bu = list(reversed(edges_src))
        # device key columns per edge (composite edges synthesize shared
        # pair-code columns; DeviceCatalog.edge_key)
        edge_keys = [cat.edge_key(q.slots[p], pcs, q.slots[c], ccs)
                     for (p, pcs, c, ccs) in edges_bu]
        proj_nodes = set()
        if with_projs:
            proj_nodes = {idx_of[p.slot] for p in q.projections
                          if p.slot in comp["set"]}
        if trail_spec is not None:
            # the trailing NULL gate needs alpha at the trailing node(s)
            proj_nodes = proj_nodes | {trail_spec[0]}
            if len(trail_spec) == 4:
                proj_nodes = proj_nodes | {trail_spec[3]}
        # needs_down: the child's subtree contains a projection node
        in_subtree = {i: {i} for i in range(len(nodes))}
        for (p, _pcs, c, _ccs) in reversed(edges_src):
            in_subtree[idx_of[p]] |= in_subtree[idx_of[c]]
        has_children = {idx_of[p] for (p, *_r) in edges_src}
        spec_edges = []
        for (p, pcs, c, ccs), (pk, ck, cmax) in zip(edges_bu, edge_keys):
            pi, ci_ = idx_of[p], idx_of[c]
            # a same-slot trailing node can't be pre (its msg_mask rides
            # the scatter); a cross-node gate leaves messages unmasked,
            # so pre stays safe at its nodes
            pre = (ci_ not in has_children and not filts_by[ci_]
                   and not sels_by[ci_] and ci_ not in tsels_spec
                   and (trail_spec is None or len(trail_spec) == 4
                        or ci_ != trail_spec[0]))
            needs_down = bool(in_subtree[ci_] & proj_nodes)
            spec_edges.append((pi, ci_, pre, needs_down, _width(cmax)))
            cols.append(pk)
            cols.append(ck)
        for (p, pcs, c, ccs), (_pi, _ci, pre, _nd, w) in zip(edges_bu,
                                                             spec_edges):
            if pre:
                if len(ccs) == 1:
                    cols.append(cat.bincount_table(q.slots[c], ccs[0]))
                else:
                    cols.append(cat.edge_bincount(q.slots[p], pcs,
                                                  q.slots[c], ccs, w))
        projs = []
        if with_projs:
            for idx, p in enumerate(q.projections):
                if p.slot not in comp["set"]:
                    continue
                for (plane, sh) in cat.proj_planes(q.slots[p.slot], p.col):
                    projs.append((idx_of[p.slot],))
                    cols.append(plane)
                    # ftree folds come from weighted_partials_segments
                    # (SEG_SHIFT pieces), not weighted_partials
                    sum_map.append((idx, "weighted_seg", sh))
        flag_nodes = tuple(i for i in range(len(nodes)) if filt_ops[i])
        root = idx_of[comp["nodes"][0]]
        n_flags = len(flag_nodes) + 1
        if variant in ("fused", "masked"):
            # NULL is decided by the companion gate/pregate spec:
            # suppress the root M-emptiness flag (a trailing entry may
            # empty the multiset without NULLing — sums-0-not-NULL)
            root = -1
            n_flags = len(flag_nodes)
        spec = (tuple(filt_ops),
                tuple(len(sels_by[i]) for i in range(len(nodes))),
                tuple(spec_edges), flag_nodes,
                root, tuple(projs), trail_spec, tuple(tsels_spec))
        return (("ftree", spec, len(cols), len(vals)), cols, vals,
                n_flags, tuple(nodes))

    def _ftree_eligible(self, st: _QState, opening) -> bool:
        """The ftree branch can only open a query: no prior join state,
        no pending expansion."""
        return (self.config.factorized and st.next_join == 0
                and opening is None and bool(st.q.joins))

    def _ftree_plan_for(self, q: Query):
        """Cached ftree plan for a query, or None if it does not
        factorize (prepared-statement style: a repeated query shape is
        planned once)."""
        key = (tuple(q.slots), tuple(q.joins), tuple(q.filters),
               tuple(q.projections))
        cached = self._ftree_plans.get(key, _UNPLANNED)
        if cached is _UNPLANNED:
            cached = None
            ft = self._extract_tree(q)
            if ft is not None:
                comp, wiped = ft
                proj_slots = {p.slot for p in q.projections
                              if p.slot in comp["set"]}
                if self._ftree_caps(q, comp, proj_slots):
                    fplan, fcols, fvals, fsum, fnf = [], [], [], [], 0
                    fnodes = []

                    def emit(w, with_projs, variant=None):
                        nonlocal fnf
                        op, c, v, nf, nd = self._plan_ftree(
                            q, w, fsum, with_projs, variant)
                        fplan.append(op)
                        fcols.extend(c)
                        fvals.extend(v)
                        fnf += nf
                        fnodes.append(nd)

                    for w in wiped:
                        emit(w, False, "gate" if w["trail_fuse"]
                             is not None else None)
                    if comp["trail_fuse"] is not None:
                        # fused tree carries the sums (root flag
                        # suppressed); the boolean companion carries the
                        # trailing pair-set NULL gate on the pre-fusion
                        # tree
                        emit(comp, True, "fused")
                        emit(comp, False, "gate")
                    elif comp.get("tsels"):
                        # multiple trailing selections: the sums spec
                        # masks them all (root flag suppressed); the
                        # trailing-free boolean companion decides NULL
                        # from the pre-trailing state
                        emit(comp, True, "masked")
                        emit(comp, False, "pregate")
                    else:
                        emit(comp, True)
                    cached = (fplan, fcols, fvals, fsum, fnf,
                              tuple(fnodes))
            self._ftree_plans[key] = cached
        return cached

    # ---- fused-stage planner + grouped driver (dense backend) ----

    def _plan_stage(self, st: _QState, opening, slot_off: int, mi: int,
                    pi):
        """Build one stage's static plan for this query, with slot indices
        offset into the group's concatenated live arrays, mat index `mi`,
        and (for a stage opened by an expansion) probe index `pi`.

        Returns (plan, cols, vals, sum_map, n_flags, sums_done);
        sum_map lists (projection index, partial kind) in PARTIALS order
        (the order the stage emits them); sums_done means every projection
        is accounted for this stage (missing indices are zero)."""
        cat = self.catalog
        q = st.q
        plan, cols, vals, sum_map = [], [], [], []
        n_flags = 0
        # factorized fast path: tree-shaped query within exact int32
        # caps => ftree ops replace filters AND the whole join pipeline
        # (filters become boolean masks inside the op; flag-only ftrees
        # gate NULL for case-1-wiped components)
        if self._ftree_eligible(st, opening):
            cached = self._ftree_plan_for(q)
            if cached is not None:
                fplan, fcols, fvals, fsum, fnf, _fnodes = cached
                plan.extend(fplan)
                cols.extend(fcols)
                vals.extend(fvals)
                sum_map.extend(fsum)
                n_flags += fnf
                st.terminal = True
                st.next_join = len(q.joins)
                st.pending = None
                self.counters["ftree_queries"] += 1
                return plan, cols, vals, sum_map, n_flags, True
        if st.next_join == 0 and opening is None:
            pristine = set(range(len(q.slots)))
            for f in q.filters:
                col = cat.col(q.slots[f.slot], f.col)
                opc, const = cat.encode_filter(f.op, f.value)
                if f.slot in pristine:
                    n = cat.relations[q.slots[f.slot]].num_tuples
                    plan.append(("ffull", f.slot + slot_off, opc,
                                 cat.bucket(n)))
                    pristine.discard(f.slot)
                else:
                    plan.append(("flive", f.slot + slot_off, opc))
                cols.append(col)
                vals.append(cat.scalar(int(const)))
                n_flags += 1
        if opening is not None:
            kind, out_size = opening
            if kind == "pair":
                _, s1, s2 = st.pending
                plan.append(("expand_pair", pi, mi, s1 + slot_off,
                             s2 + slot_off, out_size))
                st.slot_row = {s1: 0, s2: 1}
                st.defers = []              # case-1 wipe (SURVEY.md §8.5)
                st.mat_rows = 2
            else:
                _, fresh = st.pending
                plan.append(("expand_attach", pi, mi, fresh + slot_off,
                             out_size))
                st.slot_row[fresh] = st.mat_rows
                st.mat_rows += 1
            st.pending = None

        k = st.next_join
        while k < len(q.joins):
            j = q.joins[k]
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            colA = cat.col(q.slots[s1], c1)
            colB = cat.col(q.slots[s2], c2)
            if s1 == s2:
                if s1 not in st.slot_row:
                    plan.append(("eqrows", mi, s1 + slot_off))
                    st.slot_row = {s1: 0}
                    st.defers = []          # fresh same-slot wipe (§8.2)
                    st.mat_rows = 1
                else:
                    plan.append(("eqmat", mi, st.slot_row[s1],
                                 st.slot_row[s2], False))
                cols.extend((colA, colB))
                k += 1
                continue
            j1, j2 = s1 in st.slot_row, s2 in st.slot_row
            if j1 and j2:
                plan.append(("eqmat", mi, st.slot_row[s1], st.slot_row[s2],
                             True))
                cols.extend((colA, colB))
                n_flags += 1
                k += 1
                continue
            terminal = (k == len(q.joins) - 1)
            if terminal:
                if not j1 and not j2:
                    # case-1 terminal wipes any existing component,
                    # including its deferred attaches (SURVEY.md §8.5)
                    st.defers = []
                    ex_kind, rows_slot, full_row = "rows", s1, 0
                    fresh, col_full, col_fresh = s2, colA, colB
                    fresh_col = c2
                    nz = {s1: ("rows",), s2: "fresh"}
                else:
                    if j1:
                        full, fresh, col_full, col_fresh = s1, s2, colA, colB
                        fresh_col = c2
                    else:
                        full, fresh, col_full, col_fresh = s2, s1, colB, colA
                        fresh_col = c1
                    ex_kind, rows_slot, full_row = "mat", 0, st.slot_row[full]
                    nz = {fresh: "fresh"}
                    for slot, row in st.slot_row.items():
                        nz[slot] = ("mat", row)
                fresh_mult = cat.max_mult(q.slots[fresh], fresh_col)
                mult_rows = tuple(d["mult_row"] for d in st.defers) or None
                fresh_kind = "fresh" if mult_rows is None else "fresh_w"
                defer_of = {d["slot"]: d for d in st.defers}
                specs, pcols, defer_projs = [], [], []
                for idx, p in enumerate(q.projections):
                    spec = nz.get(p.slot)
                    if spec is not None:
                        planes = cat.proj_planes(q.slots[p.slot], p.col)
                        vmaxes = cat.plane_maxes(q.slots[p.slot], p.col)
                        for (plane, sh), vmax in zip(planes, vmaxes):
                            if spec == "fresh":
                                ch = channel_spec(fresh_mult, vmax)
                                specs.append(("fresh", ch))
                                sum_map.append((idx, (fresh_kind, ch), sh))
                            else:
                                specs.append(spec)
                                sum_map.append((idx, "weighted", sh))
                            pcols.append(plane)
                    elif p.slot in defer_of:
                        defer_projs.append((idx, p, defer_of[p.slot]))
                plan.append(("terminal", mi, ex_kind,
                             (fresh + slot_off, rows_slot + slot_off),
                             full_row, tuple(specs), len(pcols),
                             mult_rows))
                cols.extend((col_full, col_fresh))
                cols.extend(pcols)
                n_flags += 1
                for idx, p, d in defer_projs:
                    # projection on a deferred slot d: sum over final rows
                    # of T_d[lv_d] * terminal_count * prod(other mults)
                    excl = tuple(e["mult_row"] for e in st.defers
                                 if e is not d)
                    d_mult = cat.max_mult(*d["key_ids"])
                    planes = cat.proj_planes(q.slots[p.slot], p.col)
                    vmaxes = cat.plane_maxes(q.slots[p.slot], p.col)
                    for (plane, sh), vmax in zip(planes, vmaxes):
                        ch = channel_spec(d_mult, vmax)
                        plan.append(("project_defer", mi, full_row,
                                     fresh + slot_off, d["lv_row"],
                                     d["slot"] + slot_off, excl, ch))
                        cols.extend((col_full, col_fresh,
                                     d["col_join"], plane))
                        sum_map.append((idx, ("fresh_w", ch), sh))
                st.terminal = True
                k += 1
                continue
            # deferred middle attach (any depth): no later join references
            # this join's fresh slot -> fold it in as a multiplicity row
            # (no expansion, no readback boundary, rows never multiply)
            if self.config.defer_middle:
                later = {s for jj in q.joins[k + 1:]
                         for s in (jj.slot1, jj.slot2)}
                if j1 or j2:
                    f = s2 if j1 else s1        # case 2: fresh side fixed
                else:
                    # case 1: defer whichever side no later join references
                    f = (s2 if s2 not in later
                         else (s1 if s1 not in later else None))
                if f is not None and f not in later:
                    if j1 or j2:
                        col_full = colA if j1 else colB
                        col_fr = colB if j1 else colA
                        src = ("mat", st.slot_row[s1 if j1 else s2])
                        base_rows = st.mat_rows
                    else:
                        # fresh pair: the non-deferred side becomes the
                        # base component (wipes any prior one, §8.5)
                        base_slot = s1 if f == s2 else s2
                        col_full = colA if f == s2 else colB
                        col_fr = colB if f == s2 else colA
                        src = ("rows", base_slot + slot_off)
                        st.slot_row = {base_slot: 0}
                        st.defers = []
                        base_rows = 1
                    plan.append(("defer_attach", mi, f + slot_off, src))
                    cols.extend((col_full, col_fr))
                    n_flags += 1
                    st.defers.append({"slot": f, "mult_row": base_rows,
                                      "lv_row": base_rows + 1,
                                      "col_join": col_fr,
                                      "key_ids": (q.slots[f],
                                                  c2 if f == s2 else c1)})
                    st.mat_rows = base_rows + 2
                    k += 1
                    continue
            # non-deferable middle join: speculative expansion keeps the
            # stage going (device flag verifies; mis-speculation retries
            # on the exact readback path)
            spec = (self._spec_size(st, j)
                    if (self.config.speculate_expansions and st.speculate)
                    else None)
            if spec is not None:
                if not j1 and not j2:
                    plan.append(("spec_pair", mi, s1 + slot_off,
                                 s2 + slot_off, spec))
                    cols.extend((colA, colB))
                    st.slot_row = {s1: 0, s2: 1}
                    st.defers = []
                    st.mat_rows = 2
                else:
                    if j1:
                        full, fresh, cF, cG = s1, s2, colA, colB
                    else:
                        full, fresh, cF, cG = s2, s1, colB, colA
                    plan.append(("spec_attach", mi, st.slot_row[full],
                                 fresh + slot_off, spec))
                    cols.extend((cF, cG))
                    st.slot_row[fresh] = st.mat_rows
                    st.mat_rows += 1
                n_flags += 1                    # the total==0 NULL flag
                k += 1
                continue
            # exact path: stage ends at the probe
            if not j1 and not j2:
                plan.append(("probe1", s1 + slot_off, s2 + slot_off))
                cols.extend((colA, colB))
                st.pending = ("pair", s1, s2)
            else:
                if j1:
                    full, fresh, cF, cG = s1, s2, colA, colB
                else:
                    full, fresh, cF, cG = s2, s1, colB, colA
                plan.append(("probe2", mi, st.slot_row[full],
                             fresh + slot_off))
                cols.extend((cF, cG))
                st.pending = ("attach", fresh)
            st.next_join = k + 1
            return plan, cols, vals, sum_map, n_flags, False

        st.next_join = k
        st.pending = None
        if not st.terminal:
            # pipeline ended on a row-filter join (or no joins): limb-sum
            # projections over the materialized intermediate — weighted by
            # the deferred multiplicity product when attaches were deferred
            mult_rows = tuple(d["mult_row"] for d in st.defers)
            defer_of = {d["slot"]: d for d in st.defers}
            for idx, p in enumerate(q.projections):
                row = st.slot_row.get(p.slot)
                if row is not None:
                    for plane, sh in cat.proj_planes(q.slots[p.slot],
                                                     p.col):
                        if mult_rows:
                            plan.append(("project_w", mi, row, mult_rows))
                            sum_map.append((idx, "weighted", sh))
                        else:
                            plan.append(("project", mi, row))
                            sum_map.append((idx, "limb", sh))
                        cols.append(plane)
                elif p.slot in defer_of:
                    d = defer_of[p.slot]
                    excl = tuple(e["mult_row"] for e in st.defers
                                 if e is not d)
                    d_mult = cat.max_mult(*d["key_ids"])
                    planes = cat.proj_planes(q.slots[p.slot], p.col)
                    vmaxes = cat.plane_maxes(q.slots[p.slot], p.col)
                    for (plane, sh), vmax in zip(planes, vmaxes):
                        ch = channel_spec(d_mult, vmax)
                        plan.append(("project_defer_nt", mi, d["lv_row"],
                                     d["slot"] + slot_off, excl, ch))
                        cols.extend((d["col_join"], plane))
                        sum_map.append((idx, ("fresh_w", ch), sh))
        return plan, cols, vals, sum_map, n_flags, True

    _MAT_PLACEHOLDER_WIDTH = 1024

    def _run_round(self, round_states, openings, vecs) -> None:
        """Plan + execute ONE fused program covering every state in the
        round (openings: {state: ("pair"/"attach", out_size)}).

        The program returns ONE packed int32 vector (appended to `vecs`)
        holding every flag/spec/probe-total/partial, plus device state
        only for queries that emitted a probe (they continue next round).
        States record (vec id, offset) references; nothing is read back
        here."""
        plan, cols, vals = [], [], []
        live_in, cnt_in, mats_in, ic_in, probes_in = [], [], [], [], []
        meta = []
        # ftree-planned queries first (stable): their ops land contiguous
        # at the head of the plan, where they merge into ONE ftree_wave
        # op (level-batched kernels across queries). State order within a
        # round is free — each state keeps its own packed-vector refs.
        if self.config.ftree_wave:
            ft, rest = [], []
            for st in round_states:
                if (self._ftree_eligible(st, openings.get(id(st)))
                        and self._ftree_plan_for(st.q) is not None):
                    ft.append(st)
                else:
                    rest.append(st)
            round_states = ft + rest
        for st in round_states:
            slot_off = len(live_in)
            live_in.extend(st.live_rows)
            cnt_in.extend(st.live_cnt)
            mi = len(mats_in)
            mats_in.append(st.mat if st.mat is not None else
                           self.catalog.mat_placeholder(
                               self._MAT_PLACEHOLDER_WIDTH))
            ic_in.append(st.icount)
            opening = openings.get(id(st))
            pi = None
            if opening is not None:
                pi = len(probes_in)
                probes_in.append(st.probe)
                st.probe = None
            p, c, v, sum_map, n_flags, sums_done = self._plan_stage(
                st, opening, slot_off, mi, pi)
            emits_probe = bool(p) and p[-1][0] in ("probe1", "probe2")
            n_specs = sum(1 for op in p
                          if op[0] in ("spec_pair", "spec_attach"))
            meta.append((st, slot_off, len(st.live_rows), mi, sum_map,
                         sums_done, n_flags, emits_probe, n_specs))
            plan.extend(p)
            cols.extend(c)
            vals.extend(v)
        if not plan:
            return
        # merge the head run of ftree ops into one wave op: flags and
        # partials come back in identical per-query order, so every
        # meta/packed-layout computation below is unchanged
        if self.config.ftree_wave:
            nft = 0
            while nft < len(plan) and plan[nft][0] == "ftree":
                nft += 1
            if nft > 1:
                head = plan[:nft]
                wspecs = tuple((op[1], op[2], op[3]) for op in head)
                plan = [("ftree_wave", wspecs,
                         sum(op[2] for op in head),
                         sum(op[3] for op in head))] + plan[nft:]
        # keep sets: only a query that emitted a probe needs its device
        # state next round; finished queries leave ONLY the packed vector
        keep_slots, keep_mats, keep_probes = [], [], []
        out_pi = 0
        for (st, slot_off, n_slots, mi, _sm, _sd, _nf, emits_probe,
             _ns) in meta:
            if emits_probe:
                keep_slots.extend(range(slot_off, slot_off + n_slots))
                keep_mats.append(mi)
                keep_probes.append(out_pi)
                out_pi += 1
        self.counters["dispatches"] += 1
        plan_t = tuple(plan)
        out = self.profiler.record(
            "stage",
            run_stage(tuple(live_in), tuple(cnt_in), tuple(mats_in),
                      tuple(ic_in), tuple(probes_in), tuple(cols),
                      tuple(vals), plan_t, self.catalog.domain,
                      tuple(keep_slots), tuple(keep_mats),
                      tuple(keep_probes)),
            tuple(live_in) + tuple(mats_in))
        packed, lr_k, lc_k, mats_k, ics_k, probes_k = out
        vid = len(vecs)
        vecs.append(packed)
        slot_new = dict(zip(keep_slots, zip(lr_k, lc_k)))
        mat_new = dict(zip(keep_mats, zip(mats_k, ics_k)))
        # packed layout: [flags | specs | probe totals | partials]
        tot_flags = sum(m[6] for m in meta)
        tot_specs = sum(m[8] for m in meta)
        off_specs = tot_flags
        off_totals = tot_flags + tot_specs
        fi = si = ti = ki = 0
        poff = off_totals + sum(1 for m in meta if m[7])
        for (st, slot_off, n_slots, mi, sum_map, sums_done, n_flags,
             emits_probe, n_specs) in meta:
            for i in range(n_slots):
                upd = slot_new.get(slot_off + i)
                if upd is not None:
                    st.live_rows[i], st.live_cnt[i] = upd
            upd = mat_new.get(mi)
            if upd is not None:
                st.mat, st.icount = upd
            st.flag_refs.extend((vid, fi + j) for j in range(n_flags))
            fi += n_flags
            st.spec_refs.extend((vid, off_specs + si + j)
                                for j in range(n_specs))
            si += n_specs
            if sums_done:
                sums = [[] for _ in st.q.projections]
                for (idx, kind, shift) in sum_map:
                    shape = part_shape(kind)
                    size = int(np.prod(shape))
                    sums[idx].append((kind, (vid, poff, shape), shift))
                    poff += size
                st.sums.extend(sums)
            else:
                assert not sum_map
            if emits_probe:
                st.probe = probes_k[ki]          # (order, lo, off, cum)
                st.probe_total_ref = (vid, off_totals + ti)
                ki += 1
                ti += 1

    def _read_vecs(self, vecs, need) -> None:
        """Read packed vectors `need` (vec ids) into the host cache with
        ONE device program + ONE readback."""
        need = [v for v in need if v not in self._vec_np]
        if not need:
            return
        self.counters["readbacks"] += 1
        if len(need) == 1:
            self._vec_np[need[0]] = np.asarray(vecs[need[0]])
            return
        flat = np.asarray(jnp.concatenate([vecs[v] for v in need]))
        off = 0
        for v in need:
            n = vecs[v].shape[0]
            self._vec_np[v] = flat[off:off + n]
            off += n

    def _run_batch_fused(self, queries: Sequence[Query],
                         speculate: bool = True
                         ) -> List[Optional[List[int]]]:
        cat = self.catalog
        states = []
        for q in queries:
            st = _QState(q, speculate=speculate)
            st.icount = cat.scalar(0)
            for s in range(len(q.slots)):
                n = cat.relations[q.slots[s]].num_tuples
                st.live_rows.append(cat.iota(cat.bucket(n)))
                st.live_cnt.append(cat.scalar(n))
            states.append(st)
        vecs: List[jax.Array] = []
        self._vec_np: Dict[int, np.ndarray] = {}
        group = self.config.stage_group
        for i in range(0, len(states), group):
            self._run_round(states[i:i + group], {}, vecs)
        while True:
            pend = [st for st in states if st.probe is not None
                    and not st.null]
            if not pend:
                break
            self._read_vecs(vecs, sorted({st.probe_total_ref[0]
                                          for st in pend}))
            openings = {}
            live = []
            for st in pend:
                vid, off = st.probe_total_ref
                total = int(self._vec_np[vid][off])
                if total < 0:
                    raise JoinCapacityError(
                        "a join exceeds 2**31-1 output pairs")
                if total == 0:
                    st.null = True
                    st.probe = None
                    st.pending = None
                    continue
                # expansion programs read the live count from the probe's
                # 5th element; the total is host-known here, so ride a
                # device-cached scalar (no upload RPC)
                st.probe = (*st.probe, cat.scalar(total))
                openings[id(st)] = (st.pending[0],
                                    self.catalog.bucket(total))
                live.append(st)
            for i in range(0, len(live), group):
                chunk = live[i:i + group]
                self._run_round(chunk, openings, vecs)
        results = self._final_sweep_fused(states, vecs)
        retry = [i for i, r in enumerate(results) if r is _RETRY]
        if retry:
            # mis-speculated expansions: rerun those queries on the exact
            # readback path (speculation off => no further retries)
            self.counters["spec_retries"] += len(retry)
            redo = self._run_batch_fused([queries[i] for i in retry],
                                         speculate=False)
            for i, r in zip(retry, redo):
                results[i] = r
        return results

    def _final_sweep_fused(self, states: List[_QState], vecs
                           ) -> List[Optional[List[int]]]:
        """Resolve every packed-vector reference with ONE readback and
        combine the exact u64 sums on host (same semantics as
        _final_sweep; the data just arrives pre-packed per stage)."""
        self._read_vecs(vecs, range(len(vecs)))
        vnp = self._vec_np
        results: List[object] = []
        for st in states:
            spec_ok = all(int(vnp[v][o]) != 0 for v, o in st.spec_refs)
            if st.null:
                results.append(None if spec_ok else _RETRY)
                continue
            nulled = any(int(vnp[v][o]) != 0 for v, o in st.flag_refs)
            sums: List[int] = []
            for s in st.sums:
                total = 0
                for kind, (vid, off, shape), shift in s:
                    size = int(np.prod(shape))
                    seg = vnp[vid][off:off + size].reshape(shape)
                    # fresh-side kinds carry their static channel plan:
                    # ("fresh"|"fresh_w", channel_spec) — ops/terminal.py
                    if isinstance(kind, tuple):
                        total += _COMBINERS[kind[0]](seg, kind[1]) << shift
                    else:
                        total += _COMBINERS[kind](seg) << shift
                sums.append(total & _U64_MASK)
            if not spec_ok:
                results.append(_RETRY)
            else:
                results.append(None if nulled else sums)
        return results

    # ---- per-op driver (sort backend / fusion off) ----

    def run_batch(self, queries: Sequence[Query]) -> List[Optional[List[int]]]:
        if self.join.kind == "dense" and self.config.fuse_stages:
            return self._run_batch_fused(queries)
        states = [self._init_and_filter(q) for q in queries]

        max_joins = max((len(st.q.joins) for st in states), default=0)
        for k in range(max_joins):
            wave = []
            for st in states:
                if st.null or k >= len(st.q.joins):
                    continue
                if self._join_wave_probe(st, k):
                    wave.append(st)
            if wave:
                # one stacked readback for the whole wave's totals
                self.counters["readbacks"] += 1
                totals = np.asarray(jnp.stack([st.probe[4] for st in wave]))
                for st, total in zip(wave, totals):
                    self._join_wave_expand(st, k, int(total))

        for st in states:
            if not st.null:
                self._projections(st)
        return self._final_sweep(states)

    def _final_sweep(self, states: List[_QState]
                     ) -> List[Optional[List[int]]]:
        # final sweep: ONE readback for all flags + spec flags + partials.
        # Spec flags are read for null-marked states too: a host NULL
        # decision taken downstream of an under-sized speculative
        # expansion is unreliable and must retry.
        # The whole assembly is ONE jitted program (eager stack/reshape/
        # concat here would issue ~400 tiny dispatches) and, with partials
        # folded on device (utils/limbs.py:fold_partials), the single
        # readback fetches a few KB instead of tens of MB.
        all_flags = [f for st in states if not st.null for f in st.flags]
        all_specs = [f for st in states for f in st.spec_flags]
        parts = [e[1] for st in states if not st.null
                 for s in st.sums for e in s]
        self.counters["readbacks"] += 1
        if all_flags or all_specs or parts:
            combined = np.asarray(_assemble_sweep(
                tuple(all_flags) + tuple(all_specs), tuple(parts)))
        else:
            combined = np.zeros(0, np.int32)
        nf, ns = len(all_flags), len(all_specs)
        flags_np = combined[:nf] != 0
        specs_np = combined[nf:nf + ns] != 0
        parts_np = combined[nf + ns:]

        combiners = _COMBINERS
        results: List[object] = []
        fi = pi = si = 0
        for st in states:
            spec_ok = bool(specs_np[si:si + len(st.spec_flags)].all())
            si += len(st.spec_flags)
            if st.null:
                results.append(None if spec_ok else _RETRY)
                continue
            nulled = bool(flags_np[fi:fi + len(st.flags)].any())
            fi += len(st.flags)
            sums: List[int] = []
            for s in st.sums:
                total = 0
                for kind, arr, shift in s:
                    m = arr.size
                    seg = parts_np[pi:pi + m].reshape(arr.shape)
                    # fresh-side kinds carry their static channel plan:
                    # ("fresh"|"fresh_w", channel_spec) — see ops/terminal.py
                    if isinstance(kind, tuple):
                        total += combiners[kind[0]](seg, kind[1]) << shift
                    else:
                        total += combiners[kind](seg) << shift
                    pi += m
                sums.append(total & _U64_MASK)
            if not spec_ok:
                results.append(_RETRY)
            else:
                results.append(None if nulled else sums)
        return results
