"""Per-query device executor: filters → ordered join pipeline with row-id
intermediate chaining → exact u64 SUM projections.

Implements the validated semantic spec (SURVEY.md §9; oracle.py is the
reference implementation) entirely as statically-shaped device array programs:

* live rowid sets     — padded int32 arrays + live count   (vs. the reference's
  std::set per slot, Query.cpp:82-89)
* equi-join           — sort+searchsorted expansion, two-pass count-then-
  materialize (vs. radix partition + chained hash, Result.cpp:43-124)
* chaining cases 1/2/3 — gathers / repeat-expansion / masked compaction
  (vs. per-pair linear scans, intermediate.cpp:52-87 — 97.7% of the
  reference's runtime, SURVEY.md §6)
* SUM projections     — masked limb reduction (vs. scalar loop, Query.cpp:66-74)

Host orchestration is thin: it reads back one scalar per data-dependent
shape decision (the join output count), picks a padded shape bucket, and
dispatches the next compiled program. All compiled programs are cached by
shape bucket; the persistent JAX compilation cache makes them survive
process restarts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT
from ..ops.aggregate import sum_column_over_rows
from ..ops.compact import compact, compact_mask_positions
from ..ops.join import (JoinCapacityError, any_common, expand_pairs,
                        probe_count)
from ..ops.filter import filter_live
from ..storage import Relation
from ..workload import Query
from .device_catalog import DeviceCatalog

_U64_MASK = (1 << 64) - 1


@jax.jit
def _gather(arr: jax.Array, idx: jax.Array) -> jax.Array:
    """Device gather; out-of-bounds lanes (padding garbage) clamp under jit."""
    return arr[idx]


@jax.jit
def _eq_mask(a: jax.Array, b: jax.Array, count: jax.Array) -> jax.Array:
    n = a.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    return (a == b) & (idx < count)


class _Live:
    """A slot's live rowid set: padded device int32 rowids + host count."""

    __slots__ = ("rows", "count")

    def __init__(self, rows: jax.Array, count: int):
        self.rows = rows
        self.count = count


class JaxExecutor:
    """Executes parsed queries on the current JAX backend.

    Device state: one int32 array per referenced relation column, uploaded
    once and reused across queries (the reference re-materializes tuple
    arrays per join, structs.cpp:217-243; we never copy columns again).
    """

    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT,
                 catalog: DeviceCatalog = None):
        self.relations = relations
        self.config = config
        self.catalog = catalog or DeviceCatalog(relations, config)

    # ---- device caches (shared DeviceCatalog: codes when the dictionary
    # is active, raw int32 values otherwise) ----

    def _col(self, rel_id: int, col: int) -> jax.Array:
        return self.catalog.col(rel_id, col)

    def _all_rows(self, rel_id: int) -> _Live:
        n = self.relations[rel_id].num_tuples
        return _Live(self.catalog.iota(self._bucket(n)), n)

    def _bucket(self, n: int) -> int:
        return self.catalog.bucket(n)

    # ---- execution ----

    def execute(self, q: Query) -> Optional[List[int]]:
        """Projection sums, or None for an all-NULL line (matches oracle.py)."""
        nslots = len(q.slots)

        # 1. filters (Query.cpp:81-158)
        live: List[_Live] = [self._all_rows(q.slots[s]) for s in range(nslots)]
        for f in q.filters:
            col = self._col(q.slots[f.slot], f.col)
            lv = live[f.slot]
            opc, const = self.catalog.encode_filter(f.op, f.value)
            rows, cnt = filter_live(lv.rows, jnp.int32(lv.count), col,
                                    const, opc)
            cnt = int(cnt)
            if cnt == 0:
                return None
            live[f.slot] = _Live(rows, cnt)

        # 2. ordered join pipeline with intermediate chaining (SURVEY.md §9)
        inter: Dict[int, jax.Array] = {}   # slot -> padded rowid column
        icount = 0                          # shared live row count

        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            colA = self._col(q.slots[s1], c1)
            colB = self._col(q.slots[s2], c2)

            if s1 == s2:
                # same-slot predicate (parse_table, intermediate.cpp:11-44);
                # never triggers NULL (Query.cpp:168-170)
                if s1 not in inter:
                    # fresh slot: singleton intermediate; wipes any other
                    # component like case 1 (oracle.py, §8.2 UB extension)
                    lv = live[s1]
                    m = _eq_mask(_gather(colA, lv.rows), _gather(colB, lv.rows),
                                 jnp.int32(lv.count))
                    pos, cnt = compact_mask_positions(m)
                    inter = {s1: compact(lv.rows, pos)}
                    icount = int(cnt)
                else:
                    m = _eq_mask(_gather(colA, inter[s1]),
                                 _gather(colB, inter[s2]), jnp.int32(icount))
                    pos, cnt = compact_mask_positions(m)
                    inter = {s: compact(v, pos) for s, v in inter.items()}
                    icount = int(cnt)
                continue

            j1, j2 = s1 in inter, s2 in inter
            if not j1 and not j2:
                # case 1: both fresh (intermediate.cpp:92-103) — all matching
                # pairs between the live sets; any other slot's data is
                # discarded (quirk SURVEY.md §8.5, asserted by the engine)
                l, r = live[s1], live[s2]
                lvals = _gather(colA, l.rows)
                rvals = _gather(colB, r.rows)
                order, lo, off, cum, total = probe_count(
                    lvals, jnp.int32(l.count), rvals, jnp.int32(r.count))
                total = int(total)
                if total < 0:
                    raise JoinCapacityError(
                        "join exceeds 2**31-1 output pairs")
                if total == 0:
                    return None
                li, ri = expand_pairs(order, lo, off, cum, self._bucket(total))
                inter = {s1: _gather(l.rows, li), s2: _gather(r.rows, ri)}
                icount = total
            elif j1 and j2:
                # case 3: both joined — row filter; NULL iff the join's PAIR
                # SET is empty (Query.cpp:188-191), which can differ from the
                # filtered row count (oracle.py case 3)
                v1 = _gather(colA, inter[s1])
                v2 = _gather(colB, inter[s2])
                if not bool(any_common(v1, v2, jnp.int32(icount))):
                    return None
                m = _eq_mask(v1, v2, jnp.int32(icount))
                pos, cnt = compact_mask_positions(m)
                inter = {s: compact(v, pos) for s, v in inter.items()}
                icount = int(cnt)
            else:
                # case 2: one fresh — replicate each existing intermediate row
                # once per matching fresh rowid (gather formulation of
                # intermediate.cpp:52-66, the reference's 97.7% hotspot)
                if j1:
                    full_vals = _gather(colA, inter[s1])
                    fresh = live[s2]
                    fresh_vals = _gather(colB, fresh.rows)
                    fresh_slot = s2
                else:
                    full_vals = _gather(colB, inter[s2])
                    fresh = live[s1]
                    fresh_vals = _gather(colA, fresh.rows)
                    fresh_slot = s1
                order, lo, off, cum, total = probe_count(
                    full_vals, jnp.int32(icount),
                    fresh_vals, jnp.int32(fresh.count))
                total = int(total)
                if total < 0:
                    raise JoinCapacityError(
                        "join exceeds 2**31-1 output pairs")
                if total == 0:
                    return None
                li, ri = expand_pairs(order, lo, off, cum, self._bucket(total))
                inter = {s: _gather(v, li) for s, v in inter.items()}
                inter[fresh_slot] = _gather(fresh.rows, ri)
                icount = total

        # 3. SUM projections with multiplicity, exact u64 (Query.cpp:66-74)
        # — one limb-reduction per 16-bit plane of the original values
        # (a single identity plane for int32-ranged columns)
        sums: List[int] = []
        for p in q.projections:
            rows = inter.get(p.slot)
            if rows is None or icount == 0:
                sums.append(0)
            else:
                total = 0
                for plane, shift in self.catalog.proj_planes(
                        q.slots[p.slot], p.col):
                    total += sum_column_over_rows(
                        plane, rows, jnp.int32(icount)) << shift
                sums.append(total & _U64_MASK)
        return sums
