"""Dense direct-address equi-join backend.

When the join-key domain is bounded (the engine knows every column's max
from load-time stats; SIGMOD-contest data is < 2**18), binary search is
unnecessary: a value-indexed table gives each left value its match count
and first-match offset in O(1) lookups.

  probe:  T_cnt[v]  = multiplicity of v among live right values
                      (one scatter-add — the moral equivalent of the
                      reference's per-bucket chained hash build,
                      Result.cpp:45-58, with the radix partition dissolved
                      into direct addressing)
          T_lo[v]   = exclusive-cumsum of T_cnt = first position of v in
                      the value-sorted right side
          counts[i] = T_cnt[lv[i]], lo[i] = T_lo[lv[i]]   (two gathers)

  expand: left_of[k] via scatter-max of left indices at their output
          offsets + cummax — replacing an 8M-wide binary search
          (searchsorted) with two O(n) primitives.

Interface-compatible with ops/join.py (the sort backend): probe returns
(order, lo, offsets, cum, total); expand returns (li, ri). The sort
backend remains the fallback for unbounded domains.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .join import _total_or_overflow
from .tables import scatter_add, table_gather


@partial(jax.jit, static_argnames=("domain",))
def dense_probe(lvals, lcount, rvals, rcount, domain: int):
    """Count matches per left element via a dense value table."""
    L, R = lvals.shape[0], rvals.shape[0]
    li = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    ri = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
    rv = jnp.where(ri < rcount, rvals, np.int32(domain))      # dead -> drop
    t_cnt = scatter_add(jnp.zeros(domain, jnp.int32), rv,
                        jnp.ones(R, jnp.int32))
    t_lo = jnp.cumsum(t_cnt) - t_cnt
    # stable value-sort of the right side; dead lanes (= domain) sort last
    order = jnp.argsort(rv).astype(jnp.int32)
    lv = jnp.where(li < lcount, lvals, np.int32(-1))
    lv_safe = jnp.clip(lv, 0, domain - 1)
    cnt_g, lo = table_gather(t_cnt, lv_safe), table_gather(t_lo, lv_safe)
    counts = jnp.where(lv >= 0, cnt_g, 0)
    cum = jnp.cumsum(counts)
    return order, lo, cum - counts, cum, _total_or_overflow(cum)


@partial(jax.jit, static_argnames=("out_size",))
def dense_expand(order, lo, offsets, cum, out_size: int):
    """Materialize pair k -> (left index, right index) without binary
    search: owners scatter their index at their first output position,
    cummax fills the runs."""
    counts = cum - offsets
    L = lo.shape[0]
    idx_l = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    dest = jnp.where(counts > 0, offsets, np.int32(out_size))
    seed = jnp.full(out_size, -1, jnp.int32).at[dest].max(idx_l, mode="drop")
    left_of = jnp.maximum(jax.lax.cummax(seed), 0)
    k = jax.lax.broadcasted_iota(jnp.int32, (out_size,), 0)
    within = k - offsets[left_of]
    rpos = lo[left_of] + within
    ri = order[jnp.clip(rpos, 0, order.shape[0] - 1)]
    return left_of, ri


@partial(jax.jit, static_argnames=("domain",))
def dense_any_common(avals, bvals, count, domain: int):
    """Shared-value test via the dense table (case-3 NULL rule)."""
    n = avals.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    live = idx < count
    bv = jnp.where(live, bvals, np.int32(domain))
    t = scatter_add(jnp.zeros(domain, jnp.int32), bv, jnp.ones(n, jnp.int32))
    av = jnp.clip(jnp.where(live, avals, np.int32(0)), 0, domain - 1)
    return jnp.any((table_gather(t, av) > 0) & live)
