"""Device-resident column catalog shared by the executors.

Columns upload once and are reused by every query — the reference instead
re-materializes per-join tuple arrays (structs.cpp:217-243); here the
relation lives in device memory for the process lifetime and joins
address it with rowid gathers.

Wide (u64) values — the reference processes full-u64 columns natively
(structs.h:11-22, structs.cpp:28-39) while the device path keeps keys
and values in int32 lanes — are handled by an order-preserving global dictionary encoding:

* join/filter columns on device are dense int32 CODES into one sorted
  unique-value array covering the whole catalog. Equality of codes ==
  equality of values (global dictionary), and code order == value order,
  so strict <, >, = filter constants translate exactly
  (``encode_filter``). As a bonus the code domain is dense, so the dense
  direct-address join backend works for arbitrary u64 data.
* projection SUMs need original values: each projected column is summed as
  up to four 16-bit planes (``proj_planes``), each plane riding the
  existing exact int32 limb reductions unchanged; the host combines plane
  totals with shifts (mod 2**64).

When every column already fits int32 (SIGMOD-contest-shaped data), the
encoding is skipped entirely — codes ARE the values and nothing changes on
the fast path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig, DEFAULT
from ..storage import Relation
from ..utils.padding import bucket_size

# Values the identity (no-dictionary) device path can represent: the
# right-side join sentinel is INT32_MAX (ops/join.py), so data must stay
# strictly below.
NARROW_MAX = 2**31 - 2

_INT32_MAX = 2**31 - 1

# Projection planes on HUGE single-chip columns store as uint16 when the
# plane content fits 16 bits: at 2**30 rows an int32 plane is 4 GB —
# the uint16 plane halves it, and the exact fold path needs
# no change (utils/limbs.py:_channel_sums enters via astype(uint32),
# which zero-extends unsigned planes). Gated on row count so the golden
# workload and every non-wave consumer keep int32 planes.
_NARROW_PLANE_MIN_ROWS = 1 << 28


class DeviceCatalog:
    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, sharding=None,
                 row_shard=None):
        """`sharding`: optional jax.sharding.Sharding for small replicated
        uploads (scalars, bincount tables, placeholders).

        `row_shard`: optional (mesh, axis) — the distributed executor's
        column layout: every relation column and projection plane is
        padded to n_chips * shard_cap(rel) rows and uploaded row-sharded
        over the axis, so each chip holds ~1/N of the catalog bytes
        (supersedes /root/reference/structs.cpp:25-39's single mmap copy
        at pod scale; replaces the round-2 per-chip replication). Chip i
        owns global rowids [i*cap, (i+1)*cap); rows past the relation's
        length are padding, masked by live counts / validity masks
        everywhere. Domain-sized tables (bincounts) stay replicated —
        they are O(distinct values), not O(rows)."""
        self.relations = relations
        self.config = config
        self._sharding = sharding
        self.row_shard = row_shard
        if row_shard is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            mesh, axis = row_shard
            self._n_shards = mesh.shape[axis]
            self._row_sharding = NamedSharding(mesh, PartitionSpec(axis))
        self._cols: Dict[tuple, jax.Array] = {}
        self._planes: Dict[tuple, list] = {}
        self._iota: Dict[int, jax.Array] = {}
        # order-preserving global dictionary (built only if any column is
        # wide); None => identity encoding (codes are the values)
        self.dict_vals: Optional[np.ndarray] = None
        if any(s.max > NARROW_MAX for rel in relations for s in rel.stats):
            self._build_dictionary()

    # ---- dictionary ----

    def _build_dictionary(self) -> None:
        uniques = [np.unique(col) for rel in self.relations
                   for col in rel.values if len(col)]
        dv = (np.unique(np.concatenate(uniques)) if uniques
              else np.zeros(0, np.uint64))
        if len(dv) > NARROW_MAX:
            raise ValueError(
                f"catalog has {len(dv)} distinct values; the int32 code "
                f"space caps at {NARROW_MAX}")
        self.dict_vals = dv

    def shard_cap(self, rel_id: int) -> int:
        """Per-chip padded row capacity of a relation under row sharding:
        bucket(ceil(rows / n_chips)). Live sets (d_seed) use the same cap
        so rowid ownership aligns with column shards."""
        assert self.row_shard is not None
        rows = self.relations[rel_id].num_tuples
        return self.bucket(-(-rows // self._n_shards))

    def _put_rows(self, rel_id: int, host: np.ndarray) -> jax.Array:
        """Upload a per-row array: row-sharded (padded to n * shard_cap)
        when row_shard is set, else whole-array with self._sharding."""
        if self.row_shard is None:
            return jax.device_put(host, self._sharding)
        total = self._n_shards * self.shard_cap(rel_id)
        if len(host) < total:
            host = np.pad(host, (0, total - len(host)))
        return jax.device_put(host, self._row_sharding)

    def col(self, rel_id: int, col: int) -> jax.Array:
        """Join/filter column on device: int32 values (identity) or codes."""
        key = (rel_id, col)
        if key not in self._cols:
            if self.dict_vals is None:
                host = self.relations[rel_id].narrow_column(col)
            else:
                host = np.searchsorted(
                    self.dict_vals,
                    self.relations[rel_id].values[col]).astype(np.int32)
            self._cols[key] = self._put_rows(rel_id, host)
            if (self.dict_vals is None and key in self._planes
                    and self._planes[key][0][0].dtype == np.uint16):
                # a projection materialized a uint16 plane BEFORE this
                # join/filter needed the int32 copy: re-alias the plane
                # to the int32 column (identical values) and free the
                # uint16 copy — otherwise the column is resident TWICE
                # (6 B/row instead of 4; the aliasing decision in
                # proj_planes is order-dependent without this)
                self._planes[key] = [(self._cols[key], 0)]
        return self._cols[key]

    def encode_filter(self, op: str, value: int) -> Tuple[int, np.int32]:
        """Map a filter (op, u64 constant) onto the device code space.

        Returns (opcode, int32 constant) such that applying the strict
        comparison to device codes selects exactly the rows whose original
        value satisfies the original predicate (Query.cpp:91-146 semantics).
        """
        from ..ops.filter import OP_CODE
        opc = OP_CODE[op]
        if self.dict_vals is None:
            if value <= _INT32_MAX - 1:
                return opc, np.int32(value)
            if op == "=":
                return opc, np.int32(-1)          # no narrow value matches
            return opc, np.int32(_INT32_MAX)      # < huge: all; > huge: none
        dv = self.dict_vals
        v = np.uint64(min(value, 2**64 - 1))
        lb = int(np.searchsorted(dv, v, side="left"))
        if op == "=":
            present = lb < len(dv) and dv[lb] == v
            return opc, np.int32(lb if present else -1)
        if op == "<":
            return opc, np.int32(lb)              # value < K  <=>  code < lb
        rb = int(np.searchsorted(dv, v, side="right"))
        return opc, np.int32(rb - 1)              # value > K  <=>  code > rb-1

    def proj_planes(self, rel_id: int, col: int):
        """[(device plane column, shift)] whose shifted sums add up to the
        exact u64 SUM of the original column. One identity plane when the
        column fits int32; otherwise 16-bit planes (each plane rides the
        existing int32 limb reductions unchanged)."""
        key = (rel_id, col)
        if key not in self._planes:
            rel = self.relations[rel_id]
            # huge single-chip columns store 16-bit-fitting planes as
            # uint16 (half the HBM; folds zero-extend via astype(uint32))
            huge = (self.row_shard is None
                    and rel.num_tuples > _NARROW_PLANE_MIN_ROWS)
            if self.dict_vals is None:
                if (huge and rel.stats[col].max < (1 << 16)
                        and key not in self._cols):
                    # uint16 plane halves the HBM — but ONLY when the
                    # int32 column is not already resident for a join/
                    # filter on the same (rel, col): aliasing the
                    # existing column there costs zero extra bytes while
                    # a second uint16 copy would ADD 2 bytes/row
                    self._planes[key] = [(self._put_rows(
                        rel_id, rel.values[col].astype(np.uint16)), 0)]
                else:
                    # identity encoding: the join/filter column IS the
                    # values
                    self._planes[key] = [(self.col(rel_id, col), 0)]
            elif rel.stats[col].max <= _INT32_MAX:
                dt = (np.uint16 if huge and rel.stats[col].max < (1 << 16)
                      else np.int32)
                self._planes[key] = [(self._put_rows(
                    rel_id, rel.values[col].astype(dt)), 0)]
            else:
                host = rel.values[col]
                hi = int(rel.stats[col].max).bit_length()
                pdt = np.uint16 if huge else np.int32
                planes = []
                for shift in range(0, hi, 16):
                    p = ((host >> np.uint64(shift))
                         & np.uint64(0xFFFF)).astype(pdt)
                    planes.append((self._put_rows(rel_id, p), shift))
                self._planes[key] = planes
        return self._planes[key]

    # ---- composite (tuple) join keys ----
    #
    # A case-3 predicate paralleling an existing tree edge fuses into
    # that edge as a COMPOSITE key (models/batch.py:_extract_tree): the
    # pair (a, b) joins equal iff a pair-code joins equal under a
    # dictionary SHARED by both relations. Codes pack two int32 device
    # codes into one int64, np.unique over both relations' packs gives
    # the dense shared code space; longer tuples fold recursively
    # (code, next_col) — the ROADMAP pair-dictionary, host-built once
    # and cached. Supersedes the reference's generic multi-predicate
    # chaining (/root/reference/intermediate.cpp:72-87) at factorized
    # speed.

    def _host_codes(self, rel_id: int, col: int) -> np.ndarray:
        if self.dict_vals is None:
            return self.relations[rel_id].narrow_column(col)
        return np.searchsorted(
            self.dict_vals,
            self.relations[rel_id].values[col]).astype(np.int32)

    def _edge_key_host(self, rel_p: int, pcols: tuple, rel_c: int,
                       ccols: tuple):
        """Host half of edge_key: (pcodes, ccodes, n_codes) under one
        shared dense encoding."""
        pk = self._host_codes(rel_p, pcols[0]).astype(np.int64)
        ck = self._host_codes(rel_c, ccols[0]).astype(np.int64)
        for pc, cc in zip(pcols[1:], ccols[1:]):
            pk = (pk << 32) | self._host_codes(rel_p, pc)
            ck = (ck << 32) | self._host_codes(rel_c, cc)
            shared = np.unique(np.concatenate([pk, ck]))
            pk = np.searchsorted(shared, pk)
            ck = np.searchsorted(shared, ck)
        return pk.astype(np.int32), ck.astype(np.int32)

    def edge_key(self, rel_p: int, pcols: tuple, rel_c: int,
                 ccols: tuple):
        """Device key columns of a (possibly composite) tree edge:
        (pkey, ckey, code_max). Single-column edges are the plain catalog
        columns; composite edges get shared pair codes (dense, so
        code_max = #codes - 1)."""
        if len(pcols) == 1:
            return (self.col(rel_p, pcols[0]), self.col(rel_c, ccols[0]),
                    max(self.code_max(rel_p, pcols[0]),
                        self.code_max(rel_c, ccols[0])))
        key = ("edgekey", rel_p, pcols, rel_c, ccols)
        if not hasattr(self, "_edge_keys"):
            self._edge_keys: Dict[tuple, tuple] = {}
        if key not in self._edge_keys:
            pk, ck = self._edge_key_host(rel_p, pcols, rel_c, ccols)
            cmax = int(max(pk.max(initial=0), ck.max(initial=0)))
            self._edge_keys[key] = (self._put_rows(rel_p, pk),
                                    self._put_rows(rel_c, ck), cmax)
        return self._edge_keys[key]

    def edge_key_max_mult(self, rel_p: int, pcols: tuple, rel_c: int,
                          ccols: tuple, side: str) -> int:
        """Max multiplicity of the edge key within one side's relation
        (host scan, cached) — the composite analog of max_mult for the
        planner's overflow caps."""
        if len(pcols) == 1:
            rel, col = ((rel_p, pcols[0]) if side == "p"
                        else (rel_c, ccols[0]))
            return self.max_mult(rel, col)
        if not hasattr(self, "_edge_mults"):
            self._edge_mults: Dict[tuple, int] = {}
        key = ("edgemult", rel_p, pcols, rel_c, ccols, side)
        if key not in self._edge_mults:
            pk, ck = self._edge_key_host(rel_p, pcols, rel_c, ccols)
            codes = pk if side == "p" else ck
            if len(codes) == 0:
                self._edge_mults[key] = 1
            else:
                _, counts = np.unique(codes, return_counts=True)
                self._edge_mults[key] = int(counts.max())
        return self._edge_mults[key]

    def edge_bincount(self, rel_p: int, pcols: tuple, rel_c: int,
                      ccols: tuple, width: int) -> jax.Array:
        """Precomputed child-side key bincount for a pristine leaf of a
        composite edge (width-sized, replicated) — the composite analog
        of bincount_table."""
        key = ("edgebc", rel_p, pcols, rel_c, ccols, width)
        if not hasattr(self, "_edge_bincounts"):
            self._edge_bincounts: Dict[tuple, jax.Array] = {}
        if key not in self._edge_bincounts:
            _, ck = self._edge_key_host(rel_p, pcols, rel_c, ccols)
            t = np.bincount(ck, minlength=width).astype(np.int32)
            self._edge_bincounts[key] = jax.device_put(t, self._sharding)
        return self._edge_bincounts[key]

    def code_max(self, rel_id: int, col: int) -> int:
        """Max DEVICE CODE of a column: the load-time value max under the
        identity encoding, or the dictionary code of that max (the
        encoding is order-preserving, and the column's max value is by
        definition present). Drives per-edge message-table widths in the
        factorized planner: a table need only span the two key columns'
        code ranges, not the whole catalog domain."""
        s = self.relations[rel_id].stats[col]
        if self.dict_vals is None:
            return int(s.max)
        return int(np.searchsorted(self.dict_vals, np.uint64(s.max)))

    def max_mult(self, rel_id: int, col: int) -> int:
        """Exact max multiplicity of any value in the column (host scan,
        cached). Used by the planner to pick the widest safe fresh-sum
        channel split (ops/terminal.py:channel_spec): filters only shrink
        per-key multiplicities, so the load-time bound is valid for every
        query."""
        if not hasattr(self, "_max_mult"):
            self._max_mult: Dict[tuple, int] = {}
        key = (rel_id, col)
        if key not in self._max_mult:
            vals = self.relations[rel_id].values[col]
            if len(vals) == 0:
                self._max_mult[key] = 1
            else:
                _, counts = np.unique(vals, return_counts=True)
                self._max_mult[key] = int(counts.max())
        return self._max_mult[key]

    def plane_maxes(self, rel_id: int, col: int):
        """Max value per projection plane, aligned with proj_planes:
        identity plane -> the column's load-time max; 16-bit dictionary
        planes -> 0xFFFF."""
        planes = self.proj_planes(rel_id, col)
        s = self.relations[rel_id].stats[col]
        if len(planes) == 1 and planes[0][1] == 0 and s.max <= _INT32_MAX:
            return [int(s.max)]
        return [0xFFFF] * len(planes)

    def bincount_table(self, rel_id: int, col: int) -> jax.Array:
        """Device int32[domain] bincount of the column's device codes —
        the query-independent B table of a pristine leaf in a factorized
        tree (ops/factorized.py), superseding the reference's per-join
        hash-table build (/root/reference/Result.cpp:45-58). Built once
        per (relation, column) on host at first use."""
        if not hasattr(self, "_bincounts"):
            self._bincounts: Dict[tuple, jax.Array] = {}
        key = (rel_id, col)
        if key not in self._bincounts:
            if self.dict_vals is None:
                codes = self.relations[rel_id].narrow_column(col)
            else:
                codes = np.searchsorted(
                    self.dict_vals,
                    self.relations[rel_id].values[col]).astype(np.int32)
            t = np.bincount(codes, minlength=self.domain).astype(np.int32)
            self._bincounts[key] = jax.device_put(t, self._sharding)
        return self._bincounts[key]

    # ---- shared helpers ----

    def iota(self, size: int) -> jax.Array:
        if size not in self._iota:
            self._iota[size] = jnp.arange(size, dtype=jnp.int32)
        return self._iota[size]

    def scalar(self, value: int) -> jax.Array:
        """Device-cached int32 scalar. Host numpy scalars passed to a
        jitted call are re-uploaded per call (one host->device transfer
        each), so the executors route all recurring scalars (live
        counts, filter constants) here."""
        if not hasattr(self, "_scalars"):
            self._scalars: Dict[int, jax.Array] = {}
        v = int(value)
        if v not in self._scalars:
            self._scalars[v] = jax.device_put(np.int32(v), self._sharding)
        return self._scalars[v]

    def mat_placeholder(self, width: int) -> jax.Array:
        """Device-cached all-zero (1, width) int32 matrix — the fused
        stage runner's placeholder for queries with no intermediate yet.
        Allocating it eagerly per round would cost one allocation and
        transfer per query per run."""
        if not hasattr(self, "_placeholders"):
            self._placeholders: Dict[int, jax.Array] = {}
        if width not in self._placeholders:
            self._placeholders[width] = jax.device_put(
                np.zeros((1, width), np.int32), self._sharding)
        return self._placeholders[width]

    def bucket(self, n: int) -> int:
        return bucket_size(n, self.config.min_pad, self.config.pad_base)

    @property
    def domain(self) -> int:
        """Power-of-two bound > every device column value (codes when the
        dictionary is active), for the dense join backend's direct-address
        tables. Dictionary codes are dense, so wide data gets a dense
        domain of size = #distinct values."""
        if not hasattr(self, "_domain"):
            if self.dict_vals is not None:
                gmax = len(self.dict_vals) - 1
            else:
                gmax = 0
                for rel in self.relations:
                    for s in rel.stats:
                        gmax = max(gmax, s.max)
            d = 1024
            while d <= gmax + 1:
                d *= 2
            self._domain = d
        return self._domain
