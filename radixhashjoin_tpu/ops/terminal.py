"""Factorized terminal-join aggregation (dense backend).

The LAST join of a query never needs materializing: projections over the
would-be expanded intermediate factor into
  * existing slot s:  sum_e col_s[row_e] * match_count_e        (weighted sum)
  * fresh slot:       sum_e T[key_e],  T[v] = sum of the fresh projection
                      column over live fresh rows with join-key v
                      (a dense scatter-add table, like the probe's count
                      table but accumulating values)

This removes the single largest cost of the workload — the reference
spends 97.7% of its runtime materializing exactly these rows
(change_intermediate, intermediate.cpp:52-66; 20.8M output rows on the
small workload) — and this engine never allocates them either.
NULL detection (empty pair set, Query.cpp:188-191) becomes a deferred
device flag (total == 0), so terminal joins also need no host readback.

Value-table limbs are 11 bits (3 channels): exact while no single join
key has more than ~2**20 duplicate rows on the fresh side; the engine
falls back to materializing execution for the sort backend (unbounded
domains), which has no such bound.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.limbs import fold_partials, weighted_partials
from ..utils.limbs import _rowsum


def _dense_counts(lv, icount, rv, rcount, domain):
    """counts[i] = multiplicity of lv[i] among live rv; masked lanes 0."""
    L, R = lv.shape[0], rv.shape[0]
    li = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    ri = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
    rvm = jnp.where(ri < rcount, rv, np.int32(domain))
    t_cnt = jnp.zeros(domain, jnp.int32).at[rvm].add(1, mode="drop")
    lvm = jnp.where(li < icount, lv, np.int32(-1))
    counts = jnp.where(lvm >= 0, t_cnt[jnp.clip(lvm, 0, domain - 1)], 0)
    return counts, lvm


@partial(jax.jit, static_argnames=("domain",))
def terminal_probe_matrix(col_full, mat, row_idx, icount,
                          col_fresh_join, fresh_rows, fresh_cnt, domain):
    """Terminal case 2: (counts, lvm, total) with the full side an
    intermediate-matrix row. total==0 is the deferred NULL flag source."""
    counts, lvm = _dense_counts(col_full[mat[row_idx]], icount,
                                col_fresh_join[fresh_rows], fresh_cnt,
                                domain)
    return counts, lvm, jnp.sum(counts)


@partial(jax.jit, static_argnames=("domain",))
def terminal_probe_rows(col_l, lrows, lcount,
                        col_fresh_join, fresh_rows, fresh_cnt, domain):
    """Terminal case 1: full side is a live rowid set."""
    counts, lvm = _dense_counts(col_l[lrows], lcount,
                                col_fresh_join[fresh_rows], fresh_cnt,
                                domain)
    return counts, lvm, jnp.sum(counts)


@jax.jit
def terminal_sum_existing_matrix(col, mat, row_idx, counts, icount):
    """sum col[mat[row_idx][e]] * counts[e] over live rows (5-channel
    weighted limb partials; combine_weighted_partials on host)."""
    return weighted_partials(col[mat[row_idx]], counts, icount)


@jax.jit
def terminal_sum_existing_rows(col, rows, counts, count):
    return weighted_partials(col[rows], counts, count)


# ---- fresh-side T-table channels ----
#
# T[v] accumulates the projection column over duplicate fresh rows in an
# int32 scatter-add table, so each channel's per-key total must stay
# below 2**31. The channel split is ADAPTIVE: from the key column's exact
# load-time max multiplicity m (filters only shrink it) and the plane's
# max value V the planner picks the widest safe channels —
# m*V < 2**31 => ONE whole-value channel (one scatter-add + one gather
# instead of three), else ceil(31 - log2(m))-bit slices: one channel
# instead of three is two fewer scatter/gather pairs. Legacy default
# (unknown m): 3 x 11-bit channels, exact to m ~ 2**20.

DEFAULT_CHANNELS = ((0, 11), (11, 11), (22, 10))


def channel_spec(max_mult: int, vmax: int):
    """Static ((shift, bits), ...) channel plan for a fresh-side T table.

    Exactness: per-key channel totals are <= max_mult * (2**bits - 1),
    kept < 2**31."""
    m = max(int(max_mult), 1)
    vbits = max(int(vmax).bit_length(), 1)
    if m * int(vmax) < 2**31:
        return ((0, vbits),)
    safe = max(31 - (m - 1).bit_length() - 1, 1)
    return tuple((s, min(safe, vbits - s))
                 for s in range(0, vbits, safe))


def _fresh_tables(col_proj, col_join, fresh_rows, fresh_cnt,
                  lvm, icount, domain, channels):
    """Per-channel gathered T[lvm] vectors (masked, each entry < 2**31).

    Shared by the plain and weighted fresh-side reductions."""
    R = fresh_rows.shape[0]
    ri = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
    live_r = ri < fresh_cnt
    key = jnp.where(live_r, col_join[fresh_rows], np.int32(domain))
    pv = jnp.where(live_r, col_proj[fresh_rows], 0)

    L = lvm.shape[0]
    li = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    live_l = (li < icount) & (lvm >= 0)
    lv_safe = jnp.clip(lvm, 0, domain - 1)

    gs = []
    for shift, bits in channels:
        limb = pv if (shift == 0 and bits >= 31) else \
            ((pv >> shift) & ((1 << bits) - 1))
        t = jnp.zeros(domain, jnp.int32).at[key].add(limb, mode="drop")
        gs.append(jnp.where(live_l, t[lv_safe], 0))
    return gs


_GCHUNK = 1 << 10      # 16-bit g-limb chunk partial < 2**26 (int32-exact)


def _fresh_sum_body(col_proj, col_join, fresh_rows, fresh_cnt,
                    lvm, icount, domain, channels=DEFAULT_CHANNELS):
    """Traceable body of terminal_sum_fresh (shared with the fused op).
    Returns (C, 2, 2) folded partials (16-bit g-limb split per channel)."""
    gs = _fresh_tables(col_proj, col_join, fresh_rows, fresh_cnt,
                       lvm, icount, domain, channels)
    L = lvm.shape[0]
    outs = []
    for g in gs:
        lo = (g & 0xFFFF).reshape(L // _GCHUNK, _GCHUNK).sum(
            axis=1, dtype=jnp.int32)
        hi = (g >> 16).reshape(L // _GCHUNK, _GCHUNK).sum(
            axis=1, dtype=jnp.int32)
        outs.append(jnp.stack([lo, hi]))
    return fold_partials(jnp.stack(outs))


@partial(jax.jit, static_argnames=("domain", "channels"))
def terminal_sum_fresh(col_proj, col_join, fresh_rows, fresh_cnt,
                       lvm, icount, domain, channels=DEFAULT_CHANNELS):
    """sum over existing rows e of T[lvm[e]] where T[v] = sum of
    col_proj over live fresh rows with col_join == v.

    Returns (C, 2, 2) folded int32 partials; combine with
    combine_fresh_partials on the host."""
    return _fresh_sum_body(col_proj, col_join, fresh_rows, fresh_cnt,
                           lvm, icount, domain, channels)


def _fresh_sum_weighted(col_proj, col_join, fresh_rows, fresh_cnt,
                        lvm, weights, icount, domain,
                        channels=DEFAULT_CHANNELS):
    """sum over existing rows e of weights[e] * T[lvm[e]] — the
    multiplicity-weighted fresh-side reduction (used when a deferred
    middle attach left a `mult` row). Returns (C, 5, 2) folded int32
    partials (per T channel, weighted_partials layout)."""
    gs = _fresh_tables(col_proj, col_join, fresh_rows, fresh_cnt,
                       lvm, icount, domain, channels)
    return jnp.stack([weighted_partials(g, weights, icount) for g in gs])


def combine_fresh_w_partials(partials: np.ndarray,
                             channels=DEFAULT_CHANNELS) -> int:
    """Host combiner for _fresh_sum_weighted output (C, 5, 2) folded."""
    from ..utils.limbs import combine_weighted_partials
    p = np.asarray(partials)
    total = 0
    for c, (shift, _bits) in enumerate(channels):
        total += combine_weighted_partials(p[c]) << shift
    return total & _U64_MASK


@partial(jax.jit, static_argnames=("plan", "domain"))
def terminal_join_and_project(ex_source, icount, fresh_rows, fresh_cnt,
                              col_full, col_join_fresh, proj_cols,
                              plan, domain, mult=None):
    """ONE compiled program for the whole terminal join: dense count probe
    + every projection's reduction. Dispatch count is the dominant cost of
    the workload on a remote-attached chip (~2-7 ms per call), so the
    final join costs one dispatch instead of 1 + #projections.

    plan (static): (ex_kind, full_row, proj_specs) where ex_kind is
    "mat"/"rows", full_row indexes the intermediate matrix row holding the
    full side's rowids (ignored for "rows"), and proj_specs is a tuple of
    ("fresh", channels) | ("mat", row) | ("rows",) aligned with proj_cols
    (channels: static channel_spec for the fresh-side T table).

    `mult` (optional): per-existing-row multiplicity from a deferred
    middle attach; weighted sums then use counts*mult (bounded by the
    final row count < 2**31) and fresh sums become mult-weighted
    ("fresh_w" partials).

    Returns (empty, tuple of per-projection partials) — `empty` (device
    bool) is the deferred NULL flag, computed wrap-proof via any(counts>0)
    because the factorized pair count routinely exceeds int32 (that is the
    point of factorizing); partial kinds are "fresh"/"fresh_w"/"weighted"
    per spec and mult. Exactness bound with `mult`: no single existing row
    may contribute >= 2**31 final rows (counts*mult is an int32 product).
    """
    ex_kind, full_row, proj_specs = plan
    if ex_kind == "mat":
        lv = col_full[ex_source[full_row]]
    else:
        lv = col_full[ex_source]
    counts, lvm = _dense_counts(lv, icount, col_join_fresh[fresh_rows],
                                fresh_cnt, domain)
    empty = ~jnp.any(counts > 0)
    weight = counts if mult is None else counts * mult
    outs = []
    for spec, col in zip(proj_specs, proj_cols):
        if spec[0] == "fresh":
            ch = spec[1] if len(spec) > 1 else DEFAULT_CHANNELS
            if mult is None:
                outs.append(_fresh_sum_body(col, col_join_fresh, fresh_rows,
                                            fresh_cnt, lvm, icount, domain,
                                            ch))
            else:
                outs.append(_fresh_sum_weighted(col, col_join_fresh,
                                                fresh_rows, fresh_cnt, lvm,
                                                mult, icount, domain, ch))
        elif spec[0] == "mat":
            outs.append(weighted_partials(col[ex_source[spec[1]]], weight,
                                          icount))
        else:  # "rows"
            outs.append(weighted_partials(col[ex_source], weight, icount))
    return empty, tuple(outs)


_U64_MASK = (1 << 64) - 1


def combine_fresh_partials(partials: np.ndarray,
                           channels=DEFAULT_CHANNELS) -> int:
    """Host combiner for terminal_sum_fresh output (C, 2, 2) folded:
    per channel, [0] sums the g-vector's low 16 bits and [1] its high
    bits; the channel total then shifts by its plane offset."""
    p = np.asarray(partials)
    total = 0
    for c, (shift, _bits) in enumerate(channels):
        total += ((_rowsum(p[c, 0]) + (_rowsum(p[c, 1]) << 16)) << shift)
    return total & _U64_MASK
