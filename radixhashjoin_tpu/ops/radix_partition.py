"""Radix partition: stable digit-partitioned reordering + boundaries.

The reference's partitioner (histogram -> per-chunk prefix sums -> stable
scatter -> serial bucket-major gather, structs.cpp:111-204) reorders a
tuple array so each radix digit's rows are contiguous, with a histogram
giving bucket extents. The array formulation is one stable sort by digit —
XLA's sort is the fastest general reordering primitive — plus a
bincount for the extents; both vectorize, nothing
is serial, and stability preserves the reference's within-bucket order.

Two-level use (SURVEY.md §5): level 0 routes digits across chips
(parallel/dist_join.py's all_to_all exchange); this op is level 1, splitting
a chip's rows into digit classes for per-bucket work. The
dense direct-address backend doesn't need it (partitioning dissolves into
addressing); it serves the unbounded-domain sort backend and any consumer
that wants physically partitioned data.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def partition_by_digit(digit: jax.Array, payloads, n_bins: int):
    """Stably partition any number of aligned payload arrays by a
    precomputed digit vector (dead lanes carry digit == n_bins, sorting
    last). One stable sort + gathers — the fused equivalent of the
    reference's histogram + prefix-sum + scatter + serial gather
    (structs.cpp:111-134,182-194).

    Returns (partitioned payloads tuple, hist, offsets)."""
    order = jnp.argsort(digit, stable=True).astype(jnp.int32)
    hist = jnp.zeros(n_bins, jnp.int32).at[digit].add(1, mode="drop")
    offsets = jnp.cumsum(hist) - hist
    return tuple(p[order] for p in payloads), hist, offsets


@partial(jax.jit, static_argnames=("n_bins",))
def radix_partition(vals: jax.Array, rowids: jax.Array, count,
                    n_bins: int):
    """Stably partition (vals, rowids) by digit = vals & (n_bins-1).

    Returns (vals_part, rowids_part, hist, offsets):
      vals_part/rowids_part — rows reordered digit-major (stable within a
        digit); dead lanes (>= count) sort to the end
      hist[d]    — rows in digit d (the reference's global histogram,
        structs.cpp:168-173)
      offsets[d] — exclusive start of digit d in the partitioned arrays
    """
    n = vals.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    live = idx < count
    digit = jnp.where(live, vals & np.int32(n_bins - 1), np.int32(n_bins))
    (vp, rp), hist, offsets = partition_by_digit(digit, (vals, rowids),
                                                 n_bins)
    return vp, rp, hist, offsets
