"""Equi-join as sort + binary search + expansion (the XLA-native backend).

The reference joins via single-level radix partition + per-bucket chained
hash tables (Result.cpp:43-124, structs.cpp:144-204). A pointer-chasing hash
probe is hostile to vector lanes; the XLA-native formulation — sort the
right side once, binary-search every left value, expand match runs — was
validated to reproduce the reference's output exactly (SURVEY.md §9) and is
skew-proof (no partition can blow up; worst case is the sort's n log n).

Two-pass count-then-materialize (SURVEY.md §7): `probe_count` returns the
exact output size (host reads one scalar, picks a padded output bucket);
`expand_pairs` materializes (left_index, right_index) pairs at that size.

Padding sentinels: left values -1 (matches nothing, all data >= 0), right
values INT32_MAX (engine guarantees data <= INT32_MAX - 1 on the narrow
path). The dense direct-address backend (ops/join_dense.py) has the same
interface.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalar, NOT a jnp array: a captured device-array constant forces a
# device->host fetch at lowering time; numpy constants embed directly
# into the HLO.
RIGHT_SENTINEL = np.int32(2**31 - 1)


class JoinCapacityError(RuntimeError):
    """A single join's output exceeds 2**31 - 1 pairs (the int32 offset
    space). The reference's paged lists have no such limit
    (Result.cpp:21-35); the engine raises a diagnostic instead of silently
    overflowing. Detection is exact: per-left counts are < 2**31, so the
    int32 cumsum wraps through the negative band iff the true total does
    not fit (probe totals then come back as -1)."""


def _total_or_overflow(cum: jax.Array) -> jax.Array:
    """cum[-1], or -1 if the int32 prefix sums overflowed 2**31 - 1."""
    return jnp.where(jnp.any(cum < 0), np.int32(-1), cum[-1])


@jax.jit
def probe_count(lvals: jax.Array, lcount: jax.Array,
                rvals: jax.Array, rcount: jax.Array):
    """Count matches per left element.

    ONE stable sort of the combined [right, left] value vector + O(n)
    segmented scans — vs the naive sort(R) + two searchsorted calls
    (each a sort of L+R under method='sort'), ~3x the sort work for
    identical outputs. Within a tie run the stable sort places rights
    (lower input index) before lefts, so an inclusive right-count scan
    read at a left's position gives lo + matches directly.

    Returns (order, lo, offsets, cum, total):
      order   — int32[R] argsort of the (sentinel-masked) right values
      lo      — int32[L] first match position of each left value in sorted right
      offsets — int32[L] exclusive cumsum of per-left match counts
      cum     — int32[L] inclusive cumsum (cum[-1] == total)
      total   — int32 scalar: exact number of output pairs, or -1 if the
                join exceeds 2**31 - 1 pairs (callers raise
                JoinCapacityError)
    """
    L, R = lvals.shape[0], rvals.shape[0]
    li = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    ri = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
    lv = jnp.where(li < lcount, lvals, np.int32(-1))
    rv = jnp.where(ri < rcount, rvals, RIGHT_SENTINEL)
    n = L + R
    k = jnp.concatenate([rv, lv])
    ord_all = jnp.argsort(k, stable=True).astype(jnp.int32)
    s = k[ord_all]
    isr = (ord_all < R).astype(jnp.int32)
    rr = jnp.cumsum(isr)                      # rights at positions <= i
    e = rr - isr                              # rights strictly before i
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    new = jnp.concatenate([jnp.ones(1, jnp.bool_), s[1:] != s[:-1]])
    run_start = jax.lax.cummax(jnp.where(new, pos, np.int32(0)))
    lo_at = e[run_start]                      # rights before this value run
    cnt_at = rr - lo_at                       # rights in run up to i (= all,
    #                                           since rights precede lefts)
    # scatter back to original operand order
    lsrc = ord_all - R                        # left original index (if left)
    ldest = jnp.where(isr == 0, lsrc, np.int32(L))
    lo = jnp.zeros(L, jnp.int32).at[ldest].set(lo_at, mode="drop")
    counts = jnp.zeros(L, jnp.int32).at[ldest].set(cnt_at, mode="drop")
    order = jnp.zeros(R, jnp.int32).at[
        jnp.where(isr == 1, e, np.int32(R))].set(ord_all, mode="drop")
    cum = jnp.cumsum(counts)
    offsets = cum - counts
    return order, lo, offsets, cum, _total_or_overflow(cum)


@partial(jax.jit, static_argnames=("out_size",))
def expand_pairs(order: jax.Array, lo: jax.Array, offsets: jax.Array,
                 cum: jax.Array, out_size: int):
    """Materialize pair k in [0, out_size): (left index, right index).

    Lanes past the true total produce clipped garbage — callers mask by the
    live count from probe_count. Replaces the reference's paged result lists
    (Result.cpp:21-35) with exact-size preallocated arrays.
    """
    # Ownership (which left element produces output k) without a binary
    # search: each left element with matches scatters its index at its
    # first output position; cummax fills the runs — two O(n) primitives
    # instead of an out_size-wide searchsorted.
    counts = cum - offsets
    L = lo.shape[0]
    idx_l = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    dest = jnp.where(counts > 0, offsets, np.int32(out_size))
    seed = jnp.full(out_size, -1, jnp.int32).at[dest].max(idx_l, mode="drop")
    left_of = jnp.maximum(jax.lax.cummax(seed), 0)
    k = jax.lax.broadcasted_iota(jnp.int32, (out_size,), 0)
    within = k - offsets[left_of]
    rpos = lo[left_of] + within
    rr = order[jnp.clip(rpos, 0, order.shape[0] - 1)]
    return left_of, rr


@jax.jit
def any_common(avals: jax.Array, bvals: jax.Array, count: jax.Array):
    """True iff the live prefixes of a and b share any value.

    Implements the reference's NULL rule for a both-joined step: the join's
    *pair set* must be non-empty even though the step itself only filters
    rows (Query.cpp:188-191; oracle.py case 3).
    """
    n = avals.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    av = jnp.where(idx < count, avals, np.int32(-1))
    bv = jnp.where(idx < count, bvals, RIGHT_SENTINEL)
    bs = jnp.sort(bv)
    lo = jnp.searchsorted(bs, av, side="left", method="sort")
    hi = jnp.searchsorted(bs, av, side="right", method="sort")
    return jnp.any((hi > lo) & (idx < count))
