"""Stable stream compaction: keep masked elements, preserve order.

Array replacement for the reference's per-element `erase` loops over
rowid vectors (Query.cpp:91-146): an exclusive-scan of the keep mask gives
each survivor its destination, and a scatter with out-of-bounds drop writes
them — one vectorized pass, no data-dependent shapes (output stays padded,
the live count shrinks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def compact_mask_positions(mask: jax.Array):
    """(positions, count) for a stable compaction by `mask`.

    positions[i] = destination index if mask[i] else n (dropped on scatter).
    """
    n = mask.shape[0]
    inc = jnp.cumsum(mask.astype(jnp.int32))
    count = inc[-1]
    pos = jnp.where(mask, inc - 1, n)
    return pos, count


@jax.jit
def compact(arr: jax.Array, pos: jax.Array) -> jax.Array:
    """Scatter arr to the positions from compact_mask_positions (drop pad)."""
    out = jnp.zeros_like(arr)
    return out.at[pos].set(arr, mode="drop")
