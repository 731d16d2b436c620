"""Message-table build (weighted bincount) and lookup.

The factorized executor's two hot primitives are

    build:  B = acc.at[idxs].add(weights)   (weighted bincount)
    lookup: g = B[keys]                     (table gather)

Both are plain XLA scatter-add and gather, except one window of a huge
build whose keys are skewed: it sorts instead (`scatter_add_window`).
Out-of-range build indices drop (the wave's mask sentinel is n_bins),
like ``mode="drop"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A huge-build window whose most frequent key holds at least this share
# of a strided key sample builds by sorting (weighted_bincount_sorted):
# XLA's scatter-add serializes on a hot bin, the sort does not care.
# One H100, 2^24 rows into 2^20 bins: uniform keys 0.45 ms scatter-add
# against 1.98 ms sorted; Zipf(1.1) keys (top key 25% of rows) 3.69 ms
# against 1.93 ms. The share is where a straight line between the two
# scatter-add times crosses the sorted time; nothing between was timed.
HOT_KEY_SHARE = 1 / 8
HOT_KEY_SAMPLE = 4096


def scatter_add(acc, idxs, weights):
    """acc.at[idxs].add(weights), out-of-range indices dropped."""
    return acc.at[idxs].add(weights, mode="drop")


def weighted_bincount_sorted(idxs, weights, n_bins: int):
    """Scatter-free weighted bincount: one carrying sort + wrapped-cumsum
    boundary differences.

    jax.lax.sort carries the weights through the key sort; bin b's sum is
    cum[first >= b+1] - cum[first >= b], from ONE searchsorted of the
    n_bins+1 bin edges. The int32 cumsum wraps mod 2**32, but each true
    bin sum is < 2**31 (the factorized planner's overflow caps), so the
    wrapped difference is exact. Out-of-range idxs sort past the last
    edge and drop."""
    sk, sw = jax.lax.sort((idxs, weights), num_keys=1)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.cumsum(sw.astype(jnp.int32))])
    edges = jnp.arange(n_bins + 1, dtype=sk.dtype)
    bounds = jnp.searchsorted(sk, edges, side="left",
                              method="sort").astype(jnp.int32)
    return cum[bounds[1:]] - cum[bounds[:-1]]


def hot_key(idxs, n_bins: int):
    """True when one in-range key holds >= HOT_KEY_SHARE of a strided
    sample of idxs (HOT_KEY_SAMPLE keys; sentinel rows never count)."""
    step = max(idxs.shape[0] // HOT_KEY_SAMPLE, 1)
    s = jnp.sort(idxs[::step][:HOT_KEY_SAMPLE])
    run = (jnp.searchsorted(s, s, side="right", method="sort")
           - jnp.searchsorted(s, s, side="left", method="sort"))
    top = jnp.max(jnp.where(s < n_bins, run, 0))
    return top >= HOT_KEY_SHARE * s.shape[0]


def scatter_add_window(acc, idxs, weights):
    """scatter_add for ONE window of a huge message build (the windowed
    fori_loop bodies of ops/factorized.py:_scatter_add_big /
    _fused_node_pass), by sorting when the window's keys have a hot key
    (hot_key) and by scatter-add otherwise. Both are exact."""
    n_bins = acc.shape[0]
    return jax.lax.cond(
        hot_key(idxs, n_bins),
        lambda: acc + weighted_bincount_sorted(idxs, weights, n_bins),
        lambda: scatter_add(acc, idxs, weights))


def table_gather(table, keys):
    """g = table[keys] (keys always in range by the factorized planner's
    width construction — promise_in_bounds skips XLA's index clamp, which
    otherwise materializes a full keys-sized temp: 4 GB at a 2**30-row
    fact table)."""
    return table.at[keys].get(mode="promise_in_bounds")
