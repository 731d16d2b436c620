"""Distributed equi-join: level-0 radix exchange over the device mesh.

Two-level radix design (SURVEY.md §5 "long-context" analog): level 0 routes
every row to the chip that owns its key digit (`key mod n_chips`) via
`lax.all_to_all` — the cross-chip analog of the reference's
partition scatter (structs.cpp:123-134); level 1 is each chip's local join
over its digit class (sort+searchsorted). Because both sides route by the same digit function,
all matches are chip-local after the exchange.

Capacity discipline: `all_to_all` needs a static per-destination capacity.
The engine sizes it as `slack * ceil(shard_rows / n_chips)` from the global
histogram (config.exchange_slack); a digit heavier than capacity indicates
skew and must be handled by the skew path (broadcast join), not silently
dropped — `radix_exchange` also returns per-destination overflow counts so
callers can detect this.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

import numpy as np

from ..ops.join import RIGHT_SENTINEL
from ..ops.radix_partition import partition_by_digit

# numpy scalar, not a device array — see the note on RIGHT_SENTINEL
LEFT_SENTINEL = np.int32(-1)


def _bin_by_digit(vals: jax.Array, count: jax.Array, n_dest: int,
                  capacity: int, sentinel) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Scatter live rows into per-destination bins (n_dest, capacity).

    Returns (bins, per-destination counts, per-destination overflow).
    Rows past `count` and rows beyond capacity are dropped (overflow > 0
    signals the skew path). Stable within each destination.
    """
    n = vals.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    # drop dead lanes AND rows already sentineled by the caller (e.g. the
    # skew path parks heavy rows by sentineling them out of the exchange)
    live = (idx < count) & (vals != sentinel)
    digit = jnp.where(live, vals % n_dest, np.int32(n_dest))
    # one stable digit sort + strided gathers (ops/radix_partition.py) —
    # the same formulation as dist_ops._bin_pairs
    (vp,), hist, offs = partition_by_digit(digit, (vals,), n_dest)
    j = jax.lax.broadcasted_iota(jnp.int32, (n_dest, capacity), 1)
    src = jnp.clip(offs[:, None] + j, 0, n - 1)
    valid = j < jnp.minimum(hist, capacity)[:, None]
    bins = jnp.where(valid, vp[src], sentinel)
    counts = jnp.minimum(hist, capacity)
    overflow = jnp.maximum(hist - capacity, 0)
    return bins, counts, overflow


def _exchange(bins: jax.Array, counts: jax.Array, axis: str):
    """all_to_all: row d of my bins -> chip d; returns rows by source chip."""
    recv = jax.lax.all_to_all(bins, axis, split_axis=0, concat_axis=0,
                              tiled=True)
    recv_counts = jax.lax.all_to_all(counts.reshape(-1, 1), axis,
                                     split_axis=0, concat_axis=0,
                                     tiled=True).reshape(-1)
    return recv, recv_counts


def _flatten_valid(recv: jax.Array, recv_counts: jax.Array, sentinel):
    """(n_src, capacity) -> flat values with dead lanes set to sentinel."""
    n_src, cap = recv.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (n_src, cap), 1)
    valid = col < recv_counts[:, None]
    return jnp.where(valid, recv, sentinel).reshape(-1)


def radix_exchange(lvals, lcount, rvals, rcount, n_dest: int, capacity: int,
                   axis: str):
    """Level-0 exchange of both join sides; returns chip-local flat values
    (dead lanes sentineled) plus the max overflow across destinations."""
    lbins, lcnts, lovf = _bin_by_digit(lvals, lcount, n_dest, capacity,
                                       LEFT_SENTINEL)
    rbins, rcnts, rovf = _bin_by_digit(rvals, rcount, n_dest, capacity,
                                       RIGHT_SENTINEL)
    lrecv, lrc = _exchange(lbins, lcnts, axis)
    rrecv, rrc = _exchange(rbins, rcnts, axis)
    lflat = _flatten_valid(lrecv, lrc, LEFT_SENTINEL)
    rflat = _flatten_valid(rrecv, rrc, RIGHT_SENTINEL)
    overflow = jnp.maximum(jnp.max(lovf), jnp.max(rovf))
    return lflat, rflat, overflow


def _local_join_count_sum(lflat: jax.Array, rflat: jax.Array):
    """Chip-local join over sentineled flat values: (pair count, sum of
    matched left values as two int32 limbs). Sort+searchsorted level 1.
    method='sort': one merge-style pass instead of a binary search whose
    every step is a gather."""
    rs = jnp.sort(rflat)
    lo = jnp.searchsorted(rs, lflat, side="left",
                          method="sort").astype(jnp.int32)
    hi = jnp.searchsorted(rs, lflat, side="right",
                          method="sort").astype(jnp.int32)
    counts = hi - lo  # sentinel -1 on left never matches (data >= 0)
    pairs = jnp.sum(counts)
    # checksum: sum over pairs of the left value = sum(counts * lval), limbed
    v = jnp.maximum(lflat, 0)
    lo_limb = jnp.sum(counts * (v & 0xFFFF), dtype=jnp.int32)
    hi_limb = jnp.sum(counts * (v >> 16), dtype=jnp.int32)
    return pairs, lo_limb, hi_limb


def _digit_hist(vals, count, n_dest: int, axis: str):
    """Global per-digit histogram: local bincount + psum over the mesh —
    the cross-chip analog of the reference's per-chunk histograms + serial
    merge (structs.cpp:111-121,168-173)."""
    n = vals.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    digit = jnp.where(idx < count, vals % n_dest, np.int32(n_dest))
    local = jnp.zeros(n_dest, jnp.int32).at[digit].add(1, mode="drop")
    return jax.lax.psum(local, axis)


def dist_join_skewaware(mesh: Mesh, lvals, lcount, rvals, rcount,
                        capacity: int, heavy_fraction: float = 0.25,
                        axis: str = "x"):
    """Distributed equi-join with heavy-hitter handling.

    Digits whose global right-side share exceeds `heavy_fraction` are NOT
    shuffled (they would overflow any per-destination capacity): their
    right rows are all_gather-broadcast and joined against the left rows
    that stayed home — each (l, r) pair is counted exactly once, on l's
    home chip. Light digits take the normal all_to_all exchange. This is
    the skew valve the reference lacks entirely (SURVEY.md §5: a
    pathological key distribution lands in one bucket).

    Returns (pairs, lo_limb, hi_limb, light_overflow).
    """
    n = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(), P(), P(), P()))
    def step(lv, lc, rv, rc):
        lcnt, rcnt = lc[0], rc[0]
        nl = lv.shape[0]
        idx_l = jax.lax.broadcasted_iota(jnp.int32, (nl,), 0)
        idx_r = jax.lax.broadcasted_iota(jnp.int32, (rv.shape[0],), 0)

        ghist_r = _digit_hist(rv, rcnt, n, axis)
        total_r = jnp.maximum(jnp.sum(ghist_r), 1)
        heavy = ghist_r > (heavy_fraction * total_r).astype(jnp.int32)

        live_l = idx_l < lcnt
        live_r = idx_r < rcnt
        heavy_l = heavy[jnp.where(live_l, lv, 0) % n] & live_l
        heavy_r = heavy[jnp.where(live_r, rv, 0) % n] & live_r

        # light path: sentinel out the heavy rows, then the normal exchange
        lv_light = jnp.where(live_l & ~heavy_l, lv, LEFT_SENTINEL)
        rv_light = jnp.where(live_r & ~heavy_r, rv, RIGHT_SENTINEL)
        lflat, rflat, ovf = radix_exchange(lv_light, lcnt, rv_light, rcnt,
                                           n, capacity, axis)
        pairs_l, lo_l, hi_l = _local_join_count_sum(lflat, rflat)

        # heavy path: broadcast right heavy rows, join against home-chip
        # left heavy rows
        rv_heavy = jnp.where(heavy_r, rv, RIGHT_SENTINEL)
        r_all = jax.lax.all_gather(rv_heavy, axis).reshape(-1)
        lv_heavy = jnp.where(heavy_l, lv, LEFT_SENTINEL)
        pairs_h, lo_h, hi_h = _local_join_count_sum(lv_heavy, r_all)

        return (jax.lax.psum(pairs_l + pairs_h, axis),
                jax.lax.psum(lo_l + lo_h, axis),
                jax.lax.psum(hi_l + hi_h, axis),
                jax.lax.pmax(ovf, axis))

    return step(lvals, lcount, rvals, rcount)


def dist_join_count_sum(mesh: Mesh, lvals, lcount, rvals, rcount,
                        capacity: int, axis: str = "x"):
    """Distributed equi-join over `mesh`: global (pair count, limb sums,
    overflow). Inputs are row-sharded along `axis`; counts are per-shard
    live lengths (replicated int32 vectors of length n_chips, one entry per
    shard).

    This is the framework's "training step" shape: bin -> all_to_all ->
    local join -> psum, one compiled SPMD program.
    """
    n = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(), P(), P(), P()))
    def step(lv, lc, rv, rc):
        lflat, rflat, ovf = radix_exchange(lv, lc[0], rv, rc[0], n,
                                           capacity, axis)
        pairs, lo_limb, hi_limb = _local_join_count_sum(lflat, rflat)
        return (jax.lax.psum(pairs, axis),
                jax.lax.psum(lo_limb, axis),
                jax.lax.psum(hi_limb, axis),
                jax.lax.pmax(ovf, axis))

    return step(lvals, lcount, rvals, rcount)
