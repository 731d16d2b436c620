"""SPMD operator set for engine-level distributed query execution.

Each op is one `shard_map` program over a 1-D device mesh, jitted with the
mesh static. Data layout (the engine's multi-chip execution shape):

  * relation columns and projection planes — ROW-SHARDED over the mesh
    axis (DeviceCatalog.row_shard): chip i owns global rowids
    [i*cap, (i+1)*cap) of every relation, cap = shard_cap(rel), so each
    chip holds ~1/N of the catalog bytes. This supersedes the
    reference's single mmap copy (/root/reference/structs.cpp:25-39) at
    pod scale: a 1B-row catalog on N hosts costs each chip 1/N of HBM,
    not a full replica. Domain-sized bincount tables stay replicated.
  * live rowid sets and the (k, P) intermediate matrix — ROW-SHARDED over
    the mesh axis. The intermediate is the thing that actually grows
    (20.8M chained rows on the golden workload, BASELINE.md) and it never
    moves between chips; per-shard live counts ride a (n_chips,) array.
  * rowids in live sets stay within their owner chip's range, so
    filter/seed/fresh-side gathers are chip-local (subtract the shard
    base). Intermediate-matrix rowids are global (the case-1 exchange
    moves them across chips), so value gathers through the intermediate
    (case 2's probe side, case 3, projections) ride `_dist_gather` — a
    request/response all_to_all pair routing each rowid to its owner.

Join strategy per chaining case (supersedes the reference's single-node
partition + per-bucket build/probe, structs.cpp:123-204, Result.cpp:90-124,
at cross-chip scale):

  case 1 (both sides fresh)  — skew-aware level-0 radix exchange: light
      digits route (value, rowid) pairs to their owner chip via
      `lax.all_to_all` (the cross-chip partition scatter); digits heavier
      than `heavy_frac` of the right side broadcast the right rows via
      `all_gather` while their left rows stay home (the skew valve the
      reference lacks, SURVEY.md §5). Light/heavy sub-joins concatenate
      safely: a light left value can never equal a heavy right value
      (their digits differ in heaviness), so each matching pair is
      produced exactly once, on exactly one chip. Per-destination bin
      capacity equals the shard's own padded size, so the exchange can
      NEVER overflow by construction.
  case 2 (attach fresh slot) — broadcast join: `all_gather` the fresh
      side's (value, rowid) pairs (a filtered base relation, small) and
      join locally against the sharded intermediate (large, stays put).
  case 3 / same-slot         — purely local row filters; the global
      pair-set NULL rule needs one `all_gather` of the other side's
      values plus a `psum`-OR.

Level 1 (chip-local) joins use sentinel-aware sort + searchsorted
(skew-proof, domain-oblivious); probe totals fold the 2**31 pair-capacity
flag exactly like ops/join.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ops.chain import eq_filter_rows
from ..ops.compact import compact_mask_positions
from ..ops.factorized import run_ftree_wave
from ..ops.filter import filter_live
from ..ops.join import RIGHT_SENTINEL, _total_or_overflow, expand_pairs
from ..ops.radix_partition import partition_by_digit
from ..utils.limbs import CHUNK, MAX_PSUM_CHIPS, fold_partials, split_fold16
from .dist_join import LEFT_SENTINEL


# ---- local (per-chip) primitives used inside shard_map bodies ----

def _flat_probe(lv, rv):
    """Sentinel-aware local probe: lanes are dead iff lv == LEFT_SENTINEL
    (-1) / rv == RIGHT_SENTINEL (INT32_MAX); live lanes may appear at any
    position (post-exchange layout), unlike ops/join.py's live-prefix
    contract. Returns (order, lo, offsets, cum, total)."""
    order = jnp.argsort(rv).astype(jnp.int32)
    rs = rv[order]
    lo = jnp.searchsorted(rs, lv, side="left", method="sort").astype(jnp.int32)
    hi = jnp.searchsorted(rs, lv, side="right",
                          method="sort").astype(jnp.int32)
    counts = jnp.where(lv >= 0, hi - lo, 0)
    cum = jnp.cumsum(counts)
    return order, lo, cum - counts, cum, _total_or_overflow(cum)


def _partials_of_vals(vals):
    """Limb partial sums of pre-masked values (dead lanes already 0;
    per-shard width is a padded bucket, so the CHUNK divisibility of
    ops/aggregate holds)."""
    n = vals.shape[0]
    lo = vals & 0xFFFF
    hi = vals >> 16
    return jnp.stack([lo.reshape(n // CHUNK, CHUNK).sum(1, dtype=jnp.int32),
                      hi.reshape(n // CHUNK, CHUNK).sum(1, dtype=jnp.int32)])


def _mat_row(mat, row):
    """Row `row` (a traced scalar) of a (k, P) intermediate."""
    return jax.lax.dynamic_index_in_dim(mat, row, 0, keepdims=False)


def _shard_base(col, axis):
    """Global rowid of this chip's first column row (ownership contract:
    chip i owns rows [i*cap, (i+1)*cap), DeviceCatalog.shard_cap)."""
    return jax.lax.axis_index(axis) * np.int32(col.shape[0])


def _dist_gather(col, idxs, live, axis, n, chunks=1, cap=0):
    """Gather a row-sharded column at GLOBAL rowids owned by ANY chip.
    Returns (values (m,), overflow) — overflow is a LOCAL scalar bool
    (False whenever cap == 0); on overflow the values are garbage and
    the caller must re-dispatch with a larger capacity.

    col: this chip's row shard (cap,); global rowid g lives on chip
    g // cap at offset g % cap. idxs (m,): global rowids; live: which
    lanes are real (dead lanes return garbage).

    chunks > 1 splits the request vector into K sub-gathers: the
    request-matrix transient shrinks to (n, m/K), and the K independent
    request/response all_to_all chains give XLA's async collectives
    compute to overlap with (the same structure as the pipelined case-1
    exchange, d_case1_probe). Chunking is skipped below a 4096-lane
    floor where the extra collectives would just add latency. Exact for
    any K.

    cap > 0 bounds the PER-DESTINATION request capacity (histogram-
    sized transients): the request matrix becomes (n, cap) instead of
    the worst-case (n, m/K) — at a 10**8-row intermediate on an 8-chip
    mesh the 2x all_to_all payload drops from 8 * m/K lanes to 8 * cap.
    A destination owning more than cap of a chunk's requests raises the
    overflow flag (the verify-and-retry discipline of the join's
    capacity flag, DistExecutor._gather_retry)."""
    m = idxs.shape[0]
    k = 1
    while (k * 2 <= chunks and m % (k * 2) == 0
           and m // (k * 2) >= 4096):
        k *= 2
    if k == 1:
        return _dist_gather_chunk(col, idxs, live, axis, n, cap)
    c = m // k
    outs = [_dist_gather_chunk(col, idxs[i * c:(i + 1) * c],
                               live[i * c:(i + 1) * c], axis, n, cap)
            for i in range(k)]
    ovf = outs[0][1]
    for _v, o in outs[1:]:
        ovf = ovf | o
    return jnp.concatenate([v for v, _o in outs]), ovf


def _dist_gather_chunk(col, idxs, live, axis, n, cap=0):
    """One request/response exchange of _dist_gather. Cost: one stable
    sort + two all_to_alls + two gathers + one scatter. Returns
    (values, local overflow bool) — see _dist_gather.

    This is the cross-chip half of what the reference gets for free from
    shared memory (every thread dereferences the one mmap copy,
    /root/reference/structs.cpp:217-226); here the values move over ICI
    instead of replicating the catalog into every chip's HBM."""
    ccap = col.shape[0]
    m = idxs.shape[0]
    w = m if cap <= 0 or cap >= m else cap   # per-destination capacity
    pos = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    dest = jnp.where(live, idxs // np.int32(ccap), np.int32(n))
    (ip, pp), hist, offs = partition_by_digit(dest, (idxs, pos), n)
    j = jax.lax.broadcasted_iota(jnp.int32, (n, w), 1)
    src = jnp.clip(offs[:, None] + j, 0, m - 1)
    req = ip[src]
    req_r = jax.lax.all_to_all(req, axis, split_axis=0, concat_axis=0,
                               tiled=True)        # row s = chip s's asks
    base = jax.lax.axis_index(axis) * np.int32(ccap)
    resp = col[jnp.clip(req_r - base, 0, ccap - 1)]
    ans = jax.lax.all_to_all(resp, axis, split_axis=0, concat_axis=0,
                             tiled=True)          # row d = d's answers
    # my bin-d request at partitioned rank k sits at ans[d, k - offs[d]];
    # indexed as a 2-D gather so no flattened db*m+k product exists —
    # each per-chunk dimension is separately int32-bounded (n < 2**31
    # chips, m < 2**31 lanes), with no n*m < 2**31 coupling
    k = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    db = jnp.clip(dest[pp], 0, n - 1)
    got = ans[db, jnp.clip(k - offs[db], 0, w - 1)]
    out = jnp.zeros(m, col.dtype).at[pp].set(got, mode="drop")
    ovf = (jnp.any(hist > w) if w < m
           else jnp.zeros((), bool))              # w == m cannot drop
    return out, ovf


def _bin_pairs(vals, rows, n_dest: int, capacity: int, sentinel):
    """Stable per-destination binning of (value, rowid) pairs by digit
    (vals % n_dest); dead lanes are pre-sentineled values. With
    capacity >= the lane count nothing can drop — the level-0 scatter
    of the two-level radix (cross-chip analog of structs.cpp:123-134),
    carrying rowids. A BOUNDED capacity (the histogram-sized exchange
    transient) may truncate a destination's bin; the returned per-chip
    ovf flag says so — callers verify-and-retry exactly like the join
    capacity discipline.

    One stable digit sort + strided gathers (ops/radix_partition.py)
    instead of n_dest scan+scatter passes."""
    n = vals.shape[0]
    live = vals != sentinel
    digit = jnp.where(live, vals % np.int32(n_dest), np.int32(n_dest))
    (vp, rp), hist, offs = partition_by_digit(digit, (vals, rows), n_dest)
    j = jax.lax.broadcasted_iota(jnp.int32, (n_dest, capacity), 1)
    src = jnp.clip(offs[:, None] + j, 0, n - 1)
    valid = j < hist[:, None]
    vbins = jnp.where(valid, vp[src], sentinel)
    rbins = jnp.where(valid, rp[src], 0)
    ovf = (jnp.any(hist[:n_dest] > capacity) if capacity < n
           else jnp.zeros((), bool))
    return vbins, rbins, ovf


def _pack_prefix(flags, cap: int, *arrs):
    """Stable-compact the rows where `flags` is True into the first
    `cap` lanes (argsort of ~flags); returns the packed prefixes plus
    an overflow flag (more flagged rows than cap)."""
    pos = jnp.argsort(~flags, stable=True).astype(jnp.int32)[:cap]
    ovf = jnp.count_nonzero(flags) > cap
    return tuple(a[pos] for a in arrs) + (ovf,)


def _exchange_pairs(vals, rows, n_dest, capacity, sentinel, axis):
    """Bin + all_to_all (value, rowid) pairs in ONE stacked collective;
    returns chip-local flat (values, rowids) with dead lanes sentineled
    in values, plus the per-chip bin-overflow flag (always False when
    capacity covers the lane count)."""
    vbins, rbins, ovf = _bin_pairs(vals, rows, n_dest, capacity, sentinel)
    rec = jax.lax.all_to_all(jnp.stack([vbins, rbins]), axis,
                             split_axis=1, concat_axis=1, tiled=True)
    return rec[0].reshape(-1), rec[1].reshape(-1), ovf


def _heavy_digits(rv, n: int, heavy_frac: float, axis: str):
    """Global right-side digit histogram (psum of local bincounts — the
    cross-chip analog of structs.cpp:111-121,168-173) -> heavy mask."""
    live = rv != RIGHT_SENTINEL
    digit = jnp.where(live, rv % np.int32(n), np.int32(n))
    local = jnp.zeros(n, jnp.int32).at[digit].add(1, mode="drop")
    ghist = jax.lax.psum(local, axis)
    total = jnp.maximum(jnp.sum(ghist), 1)
    return ghist > (heavy_frac * total).astype(jnp.int32)


def _mask_heavy(vals, heavy, n, sentinel, keep_heavy: bool):
    live = vals != sentinel
    dig = jnp.where(live, vals % np.int32(n), 0)
    h = heavy[dig] & live
    keep = h if keep_heavy else (live & ~h)
    return jnp.where(keep, vals, sentinel)


# ---- SPMD ops (global-array interface; mesh/axis static) ----

@partial(jax.jit, static_argnames=("mesh", "axis", "cap"))
def d_seed(mesh, axis, nrows, cap: int):
    """Seed a slot's live set: shard i owns rowids [i*cap, (i+1)*cap) —
    the SAME ranges as the relation's column shards (cap must be
    DeviceCatalog.shard_cap), so every live-set gather is chip-local.
    nrows is traced: relations of one shard capacity share a program.
    Returns (rows (n*cap,) sharded, counts (n,) sharded)."""
    @partial(shard_map, mesh=mesh, in_specs=P(),
             out_specs=(P(axis), P(axis)))
    def body(nrows):
        i = jax.lax.axis_index(axis)
        rows = i * cap + jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
        cnt = jnp.clip(nrows - i * cap, 0, cap)
        return rows, cnt.astype(jnp.int32).reshape(1)
    return body(jnp.asarray(nrows, jnp.int32))


@partial(jax.jit, static_argnames=("mesh", "axis", "opc"))
def d_filter(mesh, axis, opc: int, rows, counts, col, const):
    """Local filter of each shard's live prefix (col is row-sharded; live
    rowids are in this chip's range, so the gather localizes by the shard
    base); returns (rows', counts', empty) where empty (replicated bool)
    is the global NULL flag."""
    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P()),
             out_specs=(P(axis), P(axis), P()))
    def body(rows, cnts, col, const):
        base = _shard_base(col, axis)
        r, c = filter_live(rows - base, cnts[0], col, const[0], opc)
        total = jax.lax.psum(c, axis)
        return r + base, c.reshape(1), total == 0
    return body(rows, counts, col, const)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def d_eq_rows(mesh, axis, colA, colB, rows, counts):
    """Fresh same-slot predicate (parse_table intended semantics,
    intermediate.cpp:17-25): local row filter -> (1, P) intermediate.
    Both columns are shards of the SAME relation, so the live rowids are
    chip-local for both gathers."""
    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(None, axis), P(axis)))
    def body(colA, colB, rows, cnts):
        base = _shard_base(colA, axis)
        r, c = eq_filter_rows(colA, colB, rows - base, cnts[0])
        return (r + base)[None], c.reshape(1)
    return body(colA, colB, rows, counts)


def _chunk_count(total: int, chunks: int) -> int:
    """Largest power-of-two chunk count <= chunks dividing total."""
    k = max(min(chunks, total), 1)
    while total % k:
        k //= 2
    return k


@partial(jax.jit, static_argnames=("mesh", "axis", "i1", "i2", "null_flag",
                                   "gchunks", "gcap", "bchunks"))
def d_eq_mat(mesh, axis, i1: int, i2: int, null_flag: bool,
             colA, colB, mat, icnts, gchunks: int = 1, gcap: int = 0,
             bchunks: int = 1):
    """Case 3 / joined same-slot: local row filter of the sharded
    intermediate. Intermediate rowids are global (the case-1 exchange
    moved them across chips), so both value gathers route through
    _dist_gather. With null_flag, also evaluates the reference's pair-set
    NULL rule GLOBALLY (Query.cpp:188-191): v1 on one chip may match v2
    on another — the test all_gathers the other side's values in
    `bchunks` width-chunks against this chip's sorted values, so the
    replicated transient is (n_chips, w/K) instead of (n_chips, w).

    Output gains a trailing replicated gather-overflow flag (gcap > 0
    bounds _dist_gather's per-destination capacity; on True the caller
    re-dispatches with a larger gcap — DistExecutor._gather_retry)."""
    n = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(None, axis), P(axis)),
             out_specs=((P(None, axis), P(axis), P(), P()) if null_flag
                        else (P(None, axis), P(axis), P())))
    def body(colA, colB, mat, icnts):
        ic = icnts[0]
        w = mat.shape[1]
        idx = jax.lax.broadcasted_iota(jnp.int32, (w,), 0)
        live = idx < ic
        v1, o1 = _dist_gather(colA, mat[i1], live, axis, n, gchunks, gcap)
        v2, o2 = _dist_gather(colB, mat[i2], live, axis, n, gchunks, gcap)
        ovf = jax.lax.psum((o1 | o2).astype(jnp.int32), axis) > 0
        m = (v1 == v2) & live
        pos, cnt = compact_mask_positions(m)
        out = jnp.zeros_like(mat).at[:, pos].set(mat, mode="drop")
        if not null_flag:
            return out, cnt.reshape(1), ovf
        v1sorted = jnp.sort(jnp.where(live, v1, LEFT_SENTINEL))
        v2s = jnp.where(live, v2, RIGHT_SENTINEL)
        K = _chunk_count(w, bchunks)
        ck = w // K
        found = jnp.array(False)
        for k in range(K):
            v2c = jax.lax.all_gather(
                jax.lax.dynamic_slice_in_dim(v2s, k * ck, ck),
                axis).reshape(-1)
            lo = jnp.searchsorted(v1sorted, v2c, side="left",
                                  method="sort")
            hi = jnp.searchsorted(v1sorted, v2c, side="right",
                                  method="sort")
            found = found | jnp.any((hi > lo) & (v2c != RIGHT_SENTINEL))
        nonempty = jax.lax.psum(found.astype(jnp.int32), axis) > 0
        return out, cnt.reshape(1), ~nonempty, ovf
    return body(colA, colB, mat, icnts)


@partial(jax.jit, static_argnames=("mesh", "axis", "heavy_frac", "chunks",
                                   "ecap"))
def d_case1_probe(mesh, axis, heavy_frac: float, chunks: int, colA, colB,
                  lrows, lcnts, rrows, rcnts, ecap: int = 0):
    """Case-1 probe: skew-aware level-0 exchange of (value, rowid) pairs,
    then the chip-local sentinel probe. Returns sharded
    (Lrow, Rrow, order, lo, off, cum, totals) + replicated
    stats = [min_total, max_total, exchange_overflow] (min < 0 => pair
    capacity overflow; exchange_overflow > 0 => a bounded exchange bin
    truncated — redispatch with a larger ecap).

    ecap > 0 bounds EVERY worst-case exchange buffer to the
    histogram-sized transient (the join/gather capacity discipline
    applied to the exchange): the right light all_to_all sends at most
    ecap pairs per destination (was capR — all rows on one chip), the
    heavy broadcast packs each chip's heavy rows into an ecap prefix
    before the all_gather (was the whole capR vector), and each left
    sub-exchange bounds at ecap/K per destination. The probe-side R
    vector shrinks from n*(capR + capR) to n*(ecap + ecap) lanes, and
    with it every argsort/searchsorted temp — the dominant per-chip
    memory of the exchange path at data scale. ecap == 0
    keeps the worst-case shapes (cannot overflow).

    PIPELINED EXCHANGE (`chunks` > 1): the left side is exchanged in K
    sub-exchanges, each probed against the sorted right side as soon as
    it lands. Chunk k's searchsorted depends only on its own all_to_all
    (plus the right sort), so the graph lets XLA's latency-hiding
    scheduler run chunk k+1's collective WHILE chunk k probes — and the
    right-side sort itself overlaps the first left chunk's exchange.
    This is BASELINE's "exchange overlapped with build/probe compute"
    (SURVEY §7 phase 5), superseding the reference's pipelined job queue
    (/root/reference/JobScheduler.cpp:103-122) at the XLA-schedule level.
    The pair multiset is identical for every K (chunking only reorders
    left lanes); tests run the golden/fuzz suites at K > 1."""
    n = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                       P(axis)),
             out_specs=(P(axis),) * 7 + (P(),))
    def body(colA, colB, lrows, lc, rrows, rc):
        capL, capR = lrows.shape[0], rrows.shape[0]
        il = jax.lax.broadcasted_iota(jnp.int32, (capL,), 0)
        ir = jax.lax.broadcasted_iota(jnp.int32, (capR,), 0)
        # fresh live rowids are chip-local (d_seed ownership contract)
        lv = jnp.where(il < lc[0], colA[lrows - _shard_base(colA, axis)],
                       LEFT_SENTINEL)
        rv = jnp.where(ir < rc[0], colB[rrows - _shard_base(colB, axis)],
                       RIGHT_SENTINEL)

        heavy = _heavy_digits(rv, n, heavy_frac, axis)

        # right side first: exchange light digits + broadcast heavy ones,
        # then ONE argsort — the build-side compute the left exchanges
        # overlap with
        rv_light = _mask_heavy(rv, heavy, n, RIGHT_SENTINEL, False)
        rcap = min(ecap, capR) if ecap else capR
        rfv, rfr, rovf = _exchange_pairs(rv_light, rrows, n, rcap,
                                         RIGHT_SENTINEL, axis)
        rv_heavy = _mask_heavy(rv, heavy, n, RIGHT_SENTINEL, True)
        if ecap and ecap < capR:
            # pack each chip's heavy rows into an ecap prefix before the
            # broadcast (non-heavy lanes are already sentineled)
            hv, hr, hovf = _pack_prefix(rv_heavy != RIGHT_SENTINEL,
                                        ecap, rv_heavy, rrows)
        else:
            hv, hr, hovf = rv_heavy, rrows, jnp.zeros((), bool)
        rgv = jax.lax.all_gather(hv, axis).reshape(-1)
        rgr = jax.lax.all_gather(hr, axis).reshape(-1)
        R = jnp.concatenate([rfv, rgv])
        Rrow = jnp.concatenate([rfr, rgr])
        order = jnp.argsort(R).astype(jnp.int32)
        rs = R[order]

        # left light path, K chunked sub-exchanges; heavy left rows stay
        # home (light x heavy cannot match — digit heaviness differs — so
        # the concatenated probe counts every global pair exactly once)
        lv_light = _mask_heavy(lv, heavy, n, LEFT_SENTINEL, False)
        lv_heavy = _mask_heavy(lv, heavy, n, LEFT_SENTINEL, True)
        K = max(min(chunks, capL), 1)
        while capL % K:
            K //= 2
        ck = capL // K
        lecap = min(max(ecap // K, 1), ck) if ecap else ck
        segs, eovfs = [], [rovf, hovf]
        for k in range(K):
            sl = slice(k * ck, (k + 1) * ck)
            lfv, lfr, lovf = _exchange_pairs(lv_light[sl], lrows[sl], n,
                                             lecap, LEFT_SENTINEL, axis)
            segs.append((lfv, lfr))
            eovfs.append(lovf)
        segs.append((lv_heavy, lrows))
        los, cnts, row_parts = [], [], []
        for (lfv, lfr) in segs:
            lo_k = jnp.searchsorted(rs, lfv, side="left",
                                    method="sort").astype(jnp.int32)
            hi_k = jnp.searchsorted(rs, lfv, side="right",
                                    method="sort").astype(jnp.int32)
            los.append(lo_k)
            cnts.append(jnp.where(lfv >= 0, hi_k - lo_k, 0))
            row_parts.append(lfr)
        lo = jnp.concatenate(los)
        counts = jnp.concatenate(cnts)
        Lrow = jnp.concatenate(row_parts)
        cum = jnp.cumsum(counts)
        total = _total_or_overflow(cum)
        eovf = jnp.stack(eovfs).any().astype(jnp.int32)
        stats = jnp.stack([jax.lax.pmin(total, axis),
                           jax.lax.pmax(total, axis),
                           jax.lax.pmax(eovf, axis)])
        return (Lrow, Rrow, order, lo, cum - counts, cum,
                total.reshape(1), stats)
    return body(colA, colB, lrows, lcnts, rrows, rcnts)


@partial(jax.jit, static_argnames=("mesh", "axis", "out_cap"))
def d_case1_expand(mesh, axis, out_cap: int, Lrow, Rrow, order, lo, off,
                   cum):
    """Materialize each chip's local pairs into a fresh (2, P)
    intermediate (lanes past the chip's total are garbage, masked by the
    per-shard counts downstream)."""
    @partial(shard_map, mesh=mesh, in_specs=(P(axis),) * 6,
             out_specs=P(None, axis))
    def body(Lrow, Rrow, order, lo, off, cum):
        li, ri = expand_pairs(order, lo, off, cum, out_cap)
        return jnp.stack([Lrow[li], Rrow[ri]])
    return body(Lrow, Rrow, order, lo, off, cum)


def _fresh_vals(col_fresh, frows, fc, axis):
    """Sentinel-padded fresh-side values (chip-local live rowids)."""
    capF = frows.shape[0]
    jf = jax.lax.broadcasted_iota(jnp.int32, (capF,), 0)
    return jnp.where(jf < fc[0],
                     col_fresh[frows - _shard_base(col_fresh, axis)],
                     RIGHT_SENTINEL)


@partial(jax.jit, static_argnames=("mesh", "axis", "gchunks", "gcap",
                                   "bchunks"))
def d_case2_probe(mesh, axis, full_row, col_full, mat, icnts,
                  col_fresh, frows, fcnts, gchunks: int = 1,
                  gcap: int = 0, bchunks: int = 1):
    """Case-2 probe: broadcast the (small, filtered) fresh side, probe the
    sharded intermediate locally — the 20M-row side never crosses ICI.
    The probe side's rowids are global, so its values arrive via
    _dist_gather; the fresh side's are chip-local.

    The fresh broadcast rides `bchunks` all_gather chunks probed one at a
    time, so the replicated transient is (n_chips, capF/K) instead of
    (n_chips, capF); only the per-lane match COUNTS survive the loop
    (d_case2_expand re-gathers chunk by chunk and writes each chunk's
    matches at running per-lane offsets — same multiset, chunk order).

    full_row (the intermediate row of the joined side) is traced, so
    every row of one intermediate shape shares a program.

    Returns (lv sharded, off, cum, totals, stats);
    stats = [min_total, max_total, gather_overflow] (overflow > 0 =>
    re-dispatch with a larger gcap, DistExecutor._gather_retry)."""
    n = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(None, axis), P(axis), P(axis),
                       P(axis), P(axis)),
             out_specs=(P(axis),) * 4 + (P(),))
    def body(full_row, col_full, mat, icnts, col_fresh, frows, fc):
        w = mat.shape[1]
        idx = jax.lax.broadcasted_iota(jnp.int32, (w,), 0)
        live = idx < icnts[0]
        gv, ovf = _dist_gather(col_full, _mat_row(mat, full_row), live,
                               axis, n, gchunks, gcap)
        lv = jnp.where(live, gv, LEFT_SENTINEL)
        fv = _fresh_vals(col_fresh, frows, fc, axis)
        capF = frows.shape[0]
        K = _chunk_count(capF, bchunks)
        ck = capF // K
        counts = jnp.zeros(w, jnp.int32)
        for k in range(K):
            fv_c = jax.lax.all_gather(
                jax.lax.dynamic_slice_in_dim(fv, k * ck, ck),
                axis).reshape(-1)
            fs = jnp.sort(fv_c)
            lo = jnp.searchsorted(fs, lv, side="left",
                                  method="sort").astype(jnp.int32)
            hi = jnp.searchsorted(fs, lv, side="right",
                                  method="sort").astype(jnp.int32)
            counts = counts + jnp.where(lv >= 0, hi - lo, 0)
        cum = jnp.cumsum(counts)
        total = _total_or_overflow(cum)
        stats = jnp.stack([jax.lax.pmin(total, axis),
                           jax.lax.pmax(total, axis),
                           jax.lax.psum(ovf.astype(jnp.int32), axis)])
        return lv, cum - counts, cum, total.reshape(1), stats
    return body(jnp.asarray(full_row, jnp.int32), col_full, mat, icnts,
                col_fresh, frows, fcnts)


@partial(jax.jit, static_argnames=("mesh", "axis", "out_cap", "bchunks"))
def d_case2_expand(mesh, axis, out_cap: int, mat, lv, col_fresh, frows,
                   fcnts, off, bchunks: int = 1):
    """Replicate each chip's intermediate rows per fresh match and attach
    the fresh rowid row (gather formulation of intermediate.cpp:52-66).

    Chunked twin of d_case2_probe: re-gathers the fresh side in the same
    `bchunks` chunks and expands each against the sharded intermediate.
    Chunk k's matches for lane L land at positions
    [running_k[L], running_k[L] + counts_k[L]) where running_k = off +
    counts of chunks < k; running_k is monotone in L with non-overlapping
    runs (off is the global per-lane cumsum), so expand_pairs' seed/
    cummax ownership stays exact per chunk and positions outside chunk
    k's runs are masked by the within-bounds test."""
    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, axis), P(axis), P(axis), P(axis), P(axis),
                       P(axis)),
             out_specs=P(None, axis))
    def body(mat, lv, col_fresh, frows, fc, off):
        fv = _fresh_vals(col_fresh, frows, fc, axis)
        capF = frows.shape[0]
        K = _chunk_count(capF, bchunks)
        ck = capF // K
        kpos = jax.lax.broadcasted_iota(jnp.int32, (out_cap,), 0)
        li_f = jnp.zeros(out_cap, jnp.int32)
        fr_f = jnp.zeros(out_cap, jnp.int32)
        running = off
        for k in range(K):
            sl = jax.lax.dynamic_slice_in_dim
            fv_c = jax.lax.all_gather(sl(fv, k * ck, ck),
                                      axis).reshape(-1)
            frow_c = jax.lax.all_gather(sl(frows, k * ck, ck),
                                        axis).reshape(-1)
            order_k = jnp.argsort(fv_c).astype(jnp.int32)
            fs = fv_c[order_k]
            lo_k = jnp.searchsorted(fs, lv, side="left",
                                    method="sort").astype(jnp.int32)
            hi_k = jnp.searchsorted(fs, lv, side="right",
                                    method="sort").astype(jnp.int32)
            counts_k = jnp.where(lv >= 0, hi_k - lo_k, 0)
            li_k, ri_k = expand_pairs(order_k, lo_k, running,
                                      running + counts_k, out_cap)
            within = kpos - running[li_k]
            valid = (within >= 0) & (within < counts_k[li_k])
            li_f = jnp.where(valid, li_k, li_f)
            fr_f = jnp.where(valid, frow_c[ri_k], fr_f)
            running = running + counts_k
        return jnp.concatenate([mat[:, li_f], fr_f[None]], axis=0)
    return body(mat, lv, col_fresh, frows, fcnts, off)


@partial(jax.jit, static_argnames=("mesh", "axis", "gchunks", "gcap"))
def d_project(mesh, axis, row, plane, mat, icnts, gchunks: int = 1,
              gcap: int = 0):
    """Exact limb partial sums of plane[mat[row]] over every shard's live
    prefix, folded per shard, split into 16-bit halves, then psum'd
    across the mesh — exact to MAX_PSUM_CHIPS (2**15) devices
    (utils/limbs.py). The host merges halves (merge_fold16) before
    combine_limb_partials. `row` is traced (one program per plane and
    intermediate shape). Returns (partials, replicated gather-overflow
    flag — True => re-dispatch with a larger gcap)."""
    n = mesh.shape[axis]
    if n > MAX_PSUM_CHIPS:
        raise ValueError(f"mesh axis {axis} has {n} devices;"
                         f" exact psum folds cap at {MAX_PSUM_CHIPS}")

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(None, axis), P(axis)),
             out_specs=(P(), P()))
    def body(row, plane, mat, icnts):
        w = mat.shape[1]
        idx = jax.lax.broadcasted_iota(jnp.int32, (w,), 0)
        live = idx < icnts[0]
        gv, ovf = _dist_gather(plane, _mat_row(mat, row), live, axis, n,
                               gchunks, gcap)
        vals = jnp.where(live, gv, 0)
        return (jax.lax.psum(split_fold16(fold_partials(
            _partials_of_vals(vals))), axis),
            jax.lax.psum(ovf.astype(jnp.int32), axis) > 0)
    return body(jnp.asarray(row, jnp.int32), plane, mat, icnts)


@partial(jax.jit, static_argnames=("mesh", "axis", "wspecs", "node_rows",
                                   "node_caps", "col_sharded"))
def d_ftree(mesh, axis, wspecs, node_rows, node_caps, col_sharded,
            cols, vals):
    """Whole factorized queries SPMD (ops/factorized.py:run_ftree_wave
    in distributed mode): every node column arrives as this chip's ROW
    SHARD (DeviceCatalog.row_shard layout — no replica exists anywhere),
    each tree level's message table goes global with ONE psum — the
    array analog of the reference's per-chunk histogram merge
    (/root/reference/structs.cpp:168-173) — and all gathers stay local.

    wspecs:      tuple of (spec, n_cols, n_vals), as in run_ftree_wave
    node_rows:   per wspec, tuple of each node's relation row count
                 (drives the validity mask)
    node_caps:   per wspec, tuple of each node's per-chip shard capacity
                 (DeviceCatalog.shard_cap of the node's relation)
    col_sharded: per col, True if row-sharded (node columns / planes),
                 False if replicated (global bincount tables)

    Returns ONE replicated packed int32 vector:
    [flags | psum'd split-half (2, n_outs, 5, 3) weighted folds,
    flattened] (halves make the psum exact to MAX_PSUM_CHIPS devices;
    the host merges them with merge_fold16)."""
    n = mesh.shape[axis]
    if n > MAX_PSUM_CHIPS:
        raise ValueError(f"mesh axis {axis} has {n} devices; exact psum "
                         f"folds cap at {MAX_PSUM_CHIPS}")
    cols = tuple(cols)
    vals = tuple(vals)
    col_specs = tuple(P(axis) if s else P() for s in col_sharded)

    @partial(shard_map, mesh=mesh,
             in_specs=(col_specs, (P(),) * len(vals)),
             out_specs=P())
    def body(cols, vals):
        idx = jax.lax.axis_index(axis)
        shards = []
        for qnodes, qcaps in zip(node_rows, node_caps):
            def slicer(col, i):
                return col     # node cols arrive pre-sharded

            def valid(i, qcaps=qcaps, qnodes=qnodes):
                cap, rows = qcaps[i], qnodes[i]
                gid = (idx * cap +
                       jax.lax.broadcasted_iota(jnp.int32, (cap,), 0))
                return gid < rows

            shards.append((slicer, valid))
        flags, outs = run_ftree_wave(wspecs, cols, vals,
                                     axis=axis, shards=tuple(shards))
        segs = []
        if flags:
            segs.append(jnp.stack(flags).astype(jnp.int32))
        if outs:
            # per-shard folded channels -> global (fold reconstruction is
            # linear; 16-bit halves keep the psum exact to 2**15 chips)
            segs.append(jax.lax.psum(split_fold16(jnp.stack(outs)),
                                     axis).reshape(-1))
        return (jnp.concatenate(segs) if segs
                else jnp.zeros(0, jnp.int32))
    return body(cols, vals)
