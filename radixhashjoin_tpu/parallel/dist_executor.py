"""Engine-level distributed query execution over a device mesh.

Runs the full validated query semantics (SURVEY.md §9 / oracle.py) SPMD:
filters, all chaining cases, NULL rules, and exact u64 SUM projections —
with live sets and the intermediate matrix row-sharded over the mesh and
the SPMD ops of parallel/dist_ops.py doing the collectives. This is what
supersedes the reference's single-node radix join (structs.cpp:123-204,
Result.cpp:90-124) at cross-chip scale; the single-chip executors
(models/) remain the latency-optimal path for one device.

Host orchestration mirrors models/executor.py: one small readback per
non-terminal join (the replicated [min,max] shard-total stats, which
drive the padded output bucket and the NULL/capacity decisions); flags
and SUM partials read back once at the end of each query.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import EngineConfig, DEFAULT
from ..models.device_catalog import DeviceCatalog
from ..oracle import format_result
from ..ops.join import JoinCapacityError
from ..storage import Relation
from ..utils.limbs import (combine_limb_partials, combine_weighted_segments,
                           merge_fold16)
from ..workload import Query
from .dist_ops import (d_case1_expand, d_case1_probe, d_case2_expand,
                       d_case2_probe, d_eq_mat, d_eq_rows, d_filter,
                       d_ftree, d_project, d_seed)
from .mesh import make_mesh

_U64_MASK = (1 << 64) - 1


class DistExecutor:
    """Distributed executor over an n-device mesh (1-D hash axis)."""

    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, mesh=None,
                 n_devices: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.axis = self.mesh.axis_names[0]
        self.n = self.mesh.shape[self.axis]
        self.config = config
        # columns/planes row-sharded over the mesh (each chip holds ~1/N
        # of the catalog); scalars + domain-sized tables replicated
        self.catalog = DeviceCatalog(
            relations, config,
            sharding=NamedSharding(self.mesh, P()),
            row_shard=(self.mesh, self.axis))
        self.relations = relations
        # factorized-tree planner (plans + cols shared via the dist
        # catalog); tree-shaped queries skip the exchange machinery
        # entirely — one psum per tree level (d_ftree)
        from ..models.batch import BatchExecutor
        self._planner = BatchExecutor(relations, config,
                                      catalog=self.catalog)
        self.counters = {"ftree_queries": 0, "exchange_queries": 0,
                         "ftree_waves": 0, "gather_retries": 0}

    # per-shard padded capacity for a slot — MUST equal the relation's
    # column shard capacity so live-set rowid ownership aligns with the
    # column shards (chip-local gathers)
    def _shard_cap(self, rel_id: int) -> int:
        return self.catalog.shard_cap(rel_id)

    def _probe_stats(self, stats) -> tuple:
        mn, mx = (int(x) for x in np.asarray(stats)[:2])
        if mn < 0:
            raise JoinCapacityError(
                "a shard's join exceeds 2**31-1 output pairs")
        return mn, mx

    def _gather_cap(self, m: int) -> int:
        """Initial per-destination _dist_gather request capacity:
        ~2x the uniform share m/n (power of two, >= 4096) — the
        histogram-sized transient replacing the worst-case (n, m/K)
        request matrix. 0 (= worst case, cannot overflow) when the
        bound would not actually shrink anything."""
        if not self.config.gather_capacity:
            return 0
        c = 4096
        # ceil(2m/n), NOT 2m//n + 1: on the all-power-of-two shapes the
        # bucketing policy produces, the +1 pushed c to the next power
        # of two (4x the uniform share) and the shrink guard below then
        # disabled the capacity entirely for n <= 8 meshes
        share = -(-2 * m // self.n)
        while c < share:
            c *= 2
        return 0 if 2 * c >= m else c

    def _gather_retry(self, m: int, dispatch):
        """Verify-and-retry around a _dist_gather-bearing dispatch (the
        join capacity discipline applied to gathers): dispatch(cap)
        returns (result, overflowed); overflow quadruples the capacity
        (a new static shape — one recompile per step, at most
        ~log4(n_chips) of them) until nothing drops; cap 0 is the
        worst-case request matrix and cannot overflow."""
        cap = self._gather_cap(m)
        while True:
            res, ovf = dispatch(cap)
            # short-circuit keeps cap == 0 readback-free (ovf may be an
            # unread device scalar; the one-readback-per-pass discipline
            # only pays for a sync when a bounded capacity was risked)
            if cap == 0 or not bool(np.asarray(ovf)):
                return res
            self.counters["gather_retries"] += 1
            cap = 0 if 8 * cap >= m else 4 * cap

    def _execute_ftree(self, q: Query, cached) -> Optional[List[int]]:
        """Distributed factorized tree: row-sharded messages, one psum
        per level, one readback for flags + psum'd sum folds."""
        return self._execute_ftree_wave([(q, cached)])[0]

    def _execute_ftree_wave(self, items) -> List[Optional[List[int]]]:
        """MANY factorized queries in ONE SPMD program (the distributed
        twin of models/batch.py's ftree_wave): every tree level's message
        scatters/gathers merge across queries, ONE dispatch and ONE
        readback per wave — on a real pod that is one collective schedule
        and one host sync for the whole batch instead of one per query.
        Supersedes the reference's per-query job loop (main.cpp:68-82)
        at pod scale."""
        self.counters["ftree_waves"] += 1
        wspecs, node_rows, node_caps = [], [], []
        cols, vals = [], []
        for q, cached in items:
            fplan, fcols, fvals, _fsum, _fnf, fnodes = cached
            for op, nd in zip(fplan, fnodes):
                wspecs.append((op[1], op[2], op[3]))
                node_rows.append(tuple(
                    self.relations[q.slots[s]].num_tuples for s in nd))
                node_caps.append(tuple(
                    self.catalog.shard_cap(q.slots[s]) for s in nd))
            cols.extend(fcols)
            vals.extend(fvals)
        col_sharded = tuple(not c.sharding.is_fully_replicated
                            for c in cols)
        packed = np.asarray(d_ftree(self.mesh, self.axis, tuple(wspecs),
                                    tuple(node_rows), tuple(node_caps),
                                    col_sharded, tuple(cols), tuple(vals)))
        total_nf = sum(cached[4] for _, cached in items)
        parts_all = merge_fold16(packed[total_nf:].reshape(2, -1, 5, 3))
        out: List[Optional[List[int]]] = []
        fo = oo = 0
        for q, cached in items:
            _fp, _fc, _fv, fsum, fnf, _fn = cached
            flags = packed[fo:fo + fnf]
            parts = parts_all[oo:oo + len(fsum)]
            fo += fnf
            oo += len(fsum)
            if flags.any():
                out.append(None)
                continue
            sums = [0] * len(q.projections)
            for (pi, _kind, shift), fold in zip(fsum, parts):
                sums[pi] = (sums[pi] +
                            (combine_weighted_segments(fold) << shift)
                            ) & _U64_MASK
            out.append(sums)
        return out

    def execute(self, q: Query) -> Optional[List[int]]:
        cat = self.catalog
        mesh, ax = self.mesh, self.axis
        nslots = len(q.slots)

        if self.config.factorized and q.joins:
            cached = self._planner._ftree_plan_for(q)
            if cached is not None:
                self.counters["ftree_queries"] += 1
                return self._execute_ftree(q, cached)
        self.counters["exchange_queries"] += 1

        live = []
        for s in range(nslots):
            nrows = self.relations[q.slots[s]].num_tuples
            live.append(list(d_seed(mesh, ax, nrows,
                                    self._shard_cap(q.slots[s]))))
        flags = []
        for f in q.filters:
            col = cat.col(q.slots[f.slot], f.col)
            opc, const = cat.encode_filter(f.op, f.value)
            rows, cnts, empty = d_filter(mesh, ax, opc, live[f.slot][0],
                                         live[f.slot][1], col,
                                         jnp.asarray([const]))
            live[f.slot] = [rows, cnts]
            flags.append(empty)

        mat = None
        icnts = None
        slot_row: Dict[int, int] = {}

        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            colA = cat.col(q.slots[s1], c1)
            colB = cat.col(q.slots[s2], c2)

            if s1 == s2:
                if s1 not in slot_row:
                    mat, icnts = d_eq_rows(mesh, ax, colA, colB,
                                           *live[s1])
                    slot_row = {s1: 0}
                else:
                    mat, icnts = self._gather_retry(
                        mat.shape[1],
                        lambda cap: (lambda o: (o[:2], o[2]))(
                            d_eq_mat(mesh, ax, slot_row[s1], slot_row[s2],
                                     False, colA, colB, mat, icnts,
                                     gchunks=self.config.gather_chunks,
                                     gcap=cap,
                                     bchunks=self.config.broadcast_chunks)))
                continue

            j1, j2 = s1 in slot_row, s2 in slot_row
            if j1 and j2:
                mat, icnts, flag = self._gather_retry(
                    mat.shape[1],
                    lambda cap: (lambda o: (o[:3], o[3]))(
                        d_eq_mat(mesh, ax, slot_row[s1], slot_row[s2],
                                 True, colA, colB, mat, icnts,
                                 gchunks=self.config.gather_chunks,
                                 gcap=cap,
                                 bchunks=self.config.broadcast_chunks)))
                flags.append(flag)
                continue

            if not j1 and not j2:
                # case 1: skew-aware cross-chip exchange (wipes others);
                # histogram-sized exchange capacity with verify-retry
                # (d_case1_probe ecap) replaces the worst-case buffers
                def disp1(cap):
                    out = d_case1_probe(
                        mesh, ax, self.config.skew_heavy_fraction,
                        self.config.exchange_chunks, colA, colB,
                        *live[s1], *live[s2], ecap=cap)
                    st = np.asarray(out[7])
                    return (out, st), st[2] > 0
                # capacity semantics are PER-CHIP rows (the probe's
                # capL). live[s][0] is the GLOBAL (n * shard_cap,)
                # sharded rowid slab (d_seed out_specs concatenate the
                # per-chip blocks), so // n recovers the per-chip capL
                # that _gather_cap expects; the initial ecap is then
                # ~2x the uniform per-destination share 2*capL/n
                # (shape[0] is n*cap, not the per-chip cap).
                ((Lrow, Rrow, order, lo, off, cum, totals, _st),
                 stats) = self._gather_retry(
                    max(live[s1][0].shape[0],
                        live[s2][0].shape[0]) // self.n, disp1)
                _, mx = self._probe_stats(stats)
                if mx == 0:
                    return None
                mat = d_case1_expand(mesh, ax, cat.bucket(mx), Lrow, Rrow,
                                     order, lo, off, cum)
                icnts = totals
                slot_row = {s1: 0, s2: 1}
            else:
                # case 2: broadcast the fresh side, expand locally
                if j1:
                    full, fresh, colF, colG = s1, s2, colA, colB
                else:
                    full, fresh, colF, colG = s2, s1, colB, colA
                def disp2(cap, full=full, colF=colF, colG=colG,
                          fresh=fresh):
                    out = d_case2_probe(
                        mesh, ax, slot_row[full], colF, mat, icnts, colG,
                        *live[fresh], gchunks=self.config.gather_chunks,
                        gcap=cap,
                        bchunks=self.config.broadcast_chunks)
                    # the overflow flag rides the stats vector the probe
                    # reads back anyway: a bounded capacity costs no
                    # extra sync here
                    st = np.asarray(out[4])
                    return (out, st), st[2] > 0
                (lv, off, _cum, totals, _st), stats = self._gather_retry(
                    mat.shape[1], disp2)
                _, mx = self._probe_stats(stats)
                if mx == 0:
                    return None
                mat = d_case2_expand(
                    mesh, ax, cat.bucket(mx), mat, lv, colG,
                    *live[fresh], off,
                    bchunks=self.config.broadcast_chunks)
                icnts = totals
                slot_row[fresh] = mat.shape[0] - 1

        # projections: psum'd limb partials per 16-bit plane
        sums: List[int] = []
        for p in q.projections:
            row = slot_row.get(p.slot)
            if row is None:
                sums.append(0)
                continue
            total = 0
            for plane, shift in cat.proj_planes(q.slots[p.slot], p.col):
                partials = self._gather_retry(
                    mat.shape[1],
                    lambda cap, plane=plane: d_project(
                        mesh, ax, row, plane, mat, icnts,
                        gchunks=self.config.gather_chunks, gcap=cap))
                total += combine_limb_partials(
                    merge_fold16(np.asarray(partials))) << shift
            sums.append(total & _U64_MASK)

        if flags and bool(np.asarray(jnp.stack(flags)).any()):
            return None
        return sums

    def run_batch_raw(self, batch: Sequence[Query]
                      ) -> List[Optional[List[int]]]:
        """One batch: factorizable queries merge into d_ftree waves of
        `stage_group` queries (one compiled program, one dispatch and one
        readback each); the rest run through the exchange pipeline one
        by one. Returns per-query sums (None = NULL line)."""
        results: List[Optional[List[int]]] = [None] * len(batch)
        wave = []
        for i, q in enumerate(batch):
            cached = None
            if self.config.factorized and self.config.ftree_wave and q.joins:
                cached = self._planner._ftree_plan_for(q)
            if cached is not None:
                self.counters["ftree_queries"] += 1
                wave.append((i, q, cached))
            else:
                results[i] = self.execute(q)
        group = max(self.config.stage_group, 1)
        for k in range(0, len(wave), group):
            chunk = wave[k:k + group]
            sums = self._execute_ftree_wave([(q, c) for _, q, c in chunk])
            for (i, _, _), s in zip(chunk, sums):
                results[i] = s
        return results

    def run_batch(self, batch: Sequence[Query]) -> List[str]:
        return [format_result(r, len(q.projections))
                for r, q in zip(self.run_batch_raw(batch), batch)]
