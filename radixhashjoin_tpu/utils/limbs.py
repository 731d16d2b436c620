"""Exact uint64 summation in 32-bit lanes.

The device path computes in int32 lanes; the output contract requires exact uint64 SUMs
(values exceed 2**32, BASELINE.md). We sum on-device in two 16-bit limbs with
chunked int32 partial sums sized so no partial can overflow, then combine the
small partial vector exactly in Python integers on the host.

Replaces the reference's scalar `sum += rel.values[col][rowid]` loop
(Query.cpp:66-74) with a vectorized, masked, limb-exact reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Rows per partial-sum chunk; divides every padding bucket (min bucket 1024).
# lo-limb partial < CHUNK * 2**16 = 2**26; hi < 2**25. Both fit int32 exactly.
CHUNK = 1 << 10

_U64_MASK = (1 << 64) - 1

# ---- device fold of chunk partials to two scalars per limb row ----
#
# Fetching (k, nchunks) partial tensors at the end of a batch would move
# tens of MB to the host. Every partial entry is < 2**26, so the chunk axis folds
# EXACTLY into two int32s [sum(p & 0x1FFF), sum(p >> 13)] for up to 2**18
# chunks (2**13 * 2**18 = 2**31); the host reconstructs
# rowsum = lo + (hi << 13) in Python integers. The readback then fetches
# a few scalars per projection instead of megabytes.

FOLD_SHIFT = 13
_FOLD_MASK = (1 << FOLD_SHIFT) - 1


def fold_partials(p: jax.Array) -> jax.Array:
    """Fold the chunk axis (last) of nonneg int32 partials (< 2**26) to
    length-2: [..., 0] = sum of low 13 bits, [..., 1] = sum of high bits."""
    assert p.shape[-1] <= (1 << 18), p.shape
    lo = (p & _FOLD_MASK).sum(axis=-1, dtype=jnp.int32)
    hi = (p >> FOLD_SHIFT).sum(axis=-1, dtype=jnp.int32)
    return jnp.stack([lo, hi], axis=-1)


def _rowsum(row: np.ndarray) -> int:
    """Host half of fold_partials: exact row total from [lo, hi]."""
    return int(row[..., 0]) + (int(row[..., 1]) << FOLD_SHIFT)


# ---- cross-chip widening of folded partials ----
#
# A folded entry is < 2**26, so a raw int32 psum over the mesh axis is
# exact only to 2**5 = 32 chips. Splitting each entry into 16-bit halves
# before the psum makes every summand < 2**16, so the halved psum stays
# exact to 2**15 chips — beyond any current pod (v5p tops out at 8,960).
# The fold reconstruction is linear, so the host merges halves first
# (entry = lo + (hi << 16), exact in int64 to 2**15 chips) and then
# combines limb partials as usual.

MAX_PSUM_CHIPS = 1 << 15


def split_fold16(x: jax.Array) -> jax.Array:
    """Device half: int32 folded partials -> stacked 16-bit halves
    (leading axis 2: [x & 0xFFFF, x >> 16]), safe to psum over up to
    MAX_PSUM_CHIPS mesh devices. Negative entries (the self-healing
    2**32-weight channels of weighted_partials_segments may wrap) split
    exactly too: x == (x >> 16 << 16) + (x & 0xFFFF) in two's
    complement, the hi half just goes negative."""
    return jnp.stack([x & 0xFFFF, x >> 16])


def merge_fold16(p: np.ndarray) -> np.ndarray:
    """Host half: psum'd split_fold16 output -> exact int64 entries."""
    p = np.asarray(p).astype(np.int64)
    return p[0] + (p[1] << 16)


@jax.jit
def sum_u32_exact(vals: jax.Array, count: jax.Array) -> jax.Array:
    """Device half: (padded int32 values in [0, 2**31), live count) ->
    (2, 2) int32 folded limb partial sums. Rows >= count contribute 0.
    Padded length must be a multiple of CHUNK (bucket sizes are powers of 2
    >= 1024, see utils/padding.py).
    """
    n = vals.shape[0]
    assert n % CHUNK == 0, n
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    v = jnp.where(idx < count, vals, 0)
    lo = v & 0xFFFF
    hi = v >> 16
    lo_p = lo.reshape(n // CHUNK, CHUNK).sum(axis=1, dtype=jnp.int32)
    hi_p = hi.reshape(n // CHUNK, CHUNK).sum(axis=1, dtype=jnp.int32)
    return fold_partials(jnp.stack([lo_p, hi_p]))


def combine_limb_partials(partials: np.ndarray) -> int:
    """Host half: exact u64 (wrapping) total from folded (2, 2) limb
    partials (psum'd folds from the distributed path combine the same
    way — the fold reconstruction is linear)."""
    p = np.asarray(partials)
    return (_rowsum(p[0]) + (_rowsum(p[1]) << 16)) & _U64_MASK


# ---- exact weighted sums: sum(vals[i] * counts[i]) with both < 2**31 ----
#
# 32x32 -> 64 product via 16-bit splits, all exact in uint32:
#   p0 = a0*b0 (< 2**32), p1 = a0*b1 + a1*b0 (< 2**32), p2 = a1*b1 (< 2**30)
#   a*b = p0 + p1*2**16 + p2*2**32
# Each p is further split into 16-bit limbs for chunked int32 accumulation.

WCHUNK = 1 << 10   # channel limb < 2**16 -> chunk partial < 2**26


@jax.jit
def weighted_partials(vals: jax.Array, counts: jax.Array,
                      count: jax.Array) -> jax.Array:
    """Device half of exact u64 sum(vals*counts) over the live prefix.
    Returns (5, 2) folded int32 channels with host weights
    [1, 2**16, 2**16, 2**32, 2**32]."""
    n = vals.shape[0]
    assert n % WCHUNK == 0, n
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    live = idx < count
    a = jnp.where(live, vals, 0).astype(jnp.uint32)
    b = jnp.where(live, counts, 0).astype(jnp.uint32)
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p0 = a0 * b0                      # exact in uint32
    p1 = a0 * b1 + a1 * b0            # each term < 2**31, sum < 2**32
    p2 = (a1 * b1).astype(jnp.int32)  # < 2**30

    def chunks(x):
        return x.reshape(n // WCHUNK, WCHUNK).sum(axis=1, dtype=jnp.int32)

    return fold_partials(jnp.stack([
        chunks((p0 & 0xFFFF).astype(jnp.int32)),       # weight 1
        chunks((p0 >> 16).astype(jnp.int32)),          # weight 2**16
        chunks((p1 & 0xFFFF).astype(jnp.int32)),       # weight 2**16
        chunks((p1 >> 16).astype(jnp.int32)),          # weight 2**32
        chunks(p2),                                    # weight 2**32
    ]))


SEG_SHIFT = 11                  # 3 pieces: [0:11), [11:22), [22:32)
_SEG_MAX_CHUNK = 1 << 15        # 16-bit-bounded channels stay < 2**31
_SEG_MAX_CHUNKS = 1 << 20       # 11-bit pieces: 2047 * 2**20 < 2**31


def seg_chunk(total_rows: int, n_segs: int) -> int:
    """Static chunk size for weighted_partials_segments: the smallest
    power of two C >= WCHUNK such that the padded chunk count
    (total_rows/C plus at most one gap chunk per segment) stays
    <= 2**20 — the bound that keeps the low-weight channels' 11-bit
    piece sums int32-exact (see weighted_partials_segments). C caps at
    2**15 (chunk partials of 16-bit-bounded channels must stay < 2**31),
    so exact segment folds cover ~2**35 total rows; beyond that this
    raises rather than silently wrapping a weight-1 carry."""
    c = WCHUNK
    # + 16: headroom for tail/gap chunks
    while total_rows // c + n_segs + 16 > _SEG_MAX_CHUNKS:
        c *= 2
        if c > _SEG_MAX_CHUNK:
            raise ValueError(
                f"exact segment folds cap at ~2**35 rows; got "
                f"{total_rows} across {n_segs} segments")
    # NOTE: ~2**35 bounds the channel ARITHMETIC only; any single
    # materialized input vector is separately capped below 2**31 rows by
    # int32 addressing (weighted_partials_big raises loudly there).
    return c


def weighted_partials_segments(vals: jax.Array, counts: jax.Array,
                               seg_ids: np.ndarray, n_segs: int,
                               chunk: int = WCHUNK) -> jax.Array:
    """Segment-batched weighted_partials: MANY exact u64 weighted sums
    in one fused channel computation + one chunk reduce + three
    scatters.

    vals/counts: 1-D int32, the segments' (value, weight) vectors back
    to back, every segment zero-padded to a `chunk` multiple (dead rows
    carry zero weight); pick `chunk` with seg_chunk. seg_ids: per-CHUNK
    segment index (a small host constant). Returns (n_segs, 5, 3) folded
    channels decoding with SEG_SHIFT=11 pieces
    (combine_weighted_segments).

    Exactness at scale (the 2**29-row silent-carry bug this replaces —
    the old 13-bit two-piece fold was exact only to 2**18 chunks, and
    wrapped a weight-1 carry silently past 2**28 rows): channels 0-3 are
    16-bit-bounded per row, so with chunk <= 2**15 their chunk partials
    stay < 2**31 exact, and the 11-bit piece split keeps every piece sum
    < 2**31 for <= 2**20 chunks (2047 * 2**20 < 2**31) — exact to ~2**35
    rows. Channel 4 (p2 = a1*b1, host weight 2**32) MAY wrap int32
    anywhere: its chunk-partial wraps are multiples of 2**32, which
    vanish mod 2**64 at weight 2**32, and its (possibly negative)
    partials still split exactly — two's complement gives
    ch == (ch & 0x7FF) + ((ch >> 11 & 0x7FF) << 11) + ((ch >> 22) << 22)
    with the sign carried by the arithmetic-shifted top piece. So no
    bound is needed there: wraps self-heal in the wrapping-u64 total.

    Replaces one ~17-HLO-op reduction PER projection with ~30 ops total
    for a whole wave of queries: each op carries a fixed launch cost
    regardless of data size."""
    n = vals.shape[0]
    assert n % chunk == 0 and n // chunk == len(seg_ids), (n, len(seg_ids))
    assert chunk <= _SEG_MAX_CHUNK and len(seg_ids) <= _SEG_MAX_CHUNKS
    ch = _channel_sums(vals, counts, chunk)          # (5, m)
    sid = jnp.asarray(seg_ids)
    zeros = jnp.zeros((5, n_segs), jnp.int32)
    lo = zeros.at[:, sid].add(ch & 0x7FF)
    mid = zeros.at[:, sid].add((ch >> SEG_SHIFT) & 0x7FF)
    hi = zeros.at[:, sid].add(ch >> (2 * SEG_SHIFT))
    return jnp.stack([lo, mid, hi], axis=-1).transpose(1, 0, 2)
    # (n_segs, 5, 3)


def _channel_sums(v, c, chunk, live_from=None):
    """(5, k) int32 chunk sums of the weighted-product channels (the
    core of weighted_partials_segments; bounds documented there). With
    live_from, rows at global index < live_from contribute zero (the
    ragged-tail mask of weighted_partials_big)."""
    a = v.astype(jnp.uint32)
    b = c.astype(jnp.uint32)
    if live_from is not None:
        idx = jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
        b = jnp.where(idx >= live_from, b, 0)
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p0 = a0 * b0
    p1 = a0 * b1 + a1 * b0
    p2 = (a1 * b1).astype(jnp.int32)
    k = v.shape[0] // chunk

    def chunks(x):
        return x.reshape(k, chunk).sum(axis=1, dtype=jnp.int32)

    return jnp.stack([chunks((p0 & 0xFFFF).astype(jnp.int32)),
                      chunks((p0 >> 16).astype(jnp.int32)),
                      chunks((p1 & 0xFFFF).astype(jnp.int32)),
                      chunks((p1 >> 16).astype(jnp.int32)),
                      chunks(p2)])                   # (5, k)


_BIG_WINDOW_ROWS = 1 << 26


def weighted_partials_big(vals: jax.Array, counts=None, *,
                          weight_table=None,
                          weight_keys=None,
                          weight_mask=None,
                          weight_fn=None,
                          vary_axis=None,
                          also_any_positive=False) -> jax.Array:
    """One exact u64 weighted sum over a HUGE vector, returning ONE
    (5, 3) fold decoding exactly like a weighted_partials_segments row.
    Length caps just below 2**31 rows: the window loop's start offsets
    (i * window) and dynamic_slice addressing are int32, so anything
    past 2**31 - _BIG_WINDOW_ROWS raises loudly rather than silently
    re-folding window 0 (the channel arithmetic alone would be exact to
    ~2**35 rows, but the addressing is the real limit).

    Built for waves whose concatenation would not fit HBM (the 2**30-row
    config-5 single-chip run): no copy of vals/counts is ever made — the
    chunk-aligned head is folded window by window under a fori_loop
    (dynamic_slice reads straight out of the operands, ~0.8 GB of temps
    per 2**26-row window; the final window is clamped to the aligned
    head and overlapping chunk sums are rewritten idempotently), and a
    ragged tail (< one chunk) folds from the last chunk-sized slice with
    the already-covered rows masked to zero weight.

    Weight sources, exactly one of:
      * counts — materialized weights, sliced window by window;
      * (weight_table, weight_keys) — gathers weight_table[weight_keys]
        window by window INSIDE the loop, so neither the gather output
        nor a clamped-index temp (each keys-length — 4 GB at 2**30
        rows) ever materializes full length;
      * weight_fn(start, size) -> int32 window — an arbitrary
        window-evaluable weight (ops/factorized.py passes a _Lazy
        PRODUCT of table gathers here for multi-edge star trees).
    weight_mask (optional bool, same length): rows where it is False
    contribute zero — also applied window by window, so a masked lazy
    fold (every distributed shard seeds a validity mask) stays
    O(window) in temps. vary_axis: mesh axis name when called inside
    shard_map on per-chip data (the fori_loop carry init must be marked
    device-varying to match the body's output type).

    also_any_positive: additionally return any(weight > 0) folded in
    the SAME window loop, so a caller needing the emptiness bit (the
    factorized root NULL flag) pays zero extra passes over the operands
    — at 2**30 rows a separate flag loop would re-gather the whole
    weight product. Returns (fold, bool)."""
    lazy = counts is None and weight_fn is None
    assert lazy == (weight_table is not None)
    assert weight_fn is None or (counts is None and weight_table is None)

    def weights_of(idx_vec):
        return weight_table.at[idx_vec].get(mode="promise_in_bounds")

    n = vals.shape[0]
    if n >= (1 << 31) - _BIG_WINDOW_ROWS:
        raise ValueError(
            f"weighted_partials_big caps at 2**31 - {_BIG_WINDOW_ROWS} "
            f"rows (int32 window addressing); got {n}")
    chunk = seg_chunk(n, 1)
    n_al = (n // chunk) * chunk
    m = n_al // chunk
    if n <= _BIG_WINDOW_ROWS or m == 0:
        if weight_fn is not None:
            c_full = weight_fn(np.int32(0), n)
        else:
            c_full = weights_of(weight_keys) if lazy else counts
        if weight_mask is not None:
            c_full = jnp.where(weight_mask, c_full, 0)
        anyp = jnp.any(c_full > 0) if also_any_positive else None
        pad = -n % chunk
        if pad:
            z = jnp.zeros(pad, jnp.int32)
            vals = jnp.concatenate([vals, z])
            c_full = jnp.concatenate([c_full, z])
        ch = _channel_sums(vals, c_full, chunk)
    else:
        w_rows = _BIG_WINDOW_ROWS           # chunk | w_rows (both pow2)
        nw = -(-n_al // w_rows)
        cnt_src = weight_keys if lazy else counts

        def window_weights(start, size):
            if weight_fn is not None:
                c = weight_fn(start, size)
            else:
                c = jax.lax.dynamic_slice(cnt_src, (start,), (size,))
                if lazy:
                    c = weights_of(c)
            if weight_mask is not None:
                mk = jax.lax.dynamic_slice(weight_mask, (start,), (size,))
                c = jnp.where(mk, c, 0)
            return c

        def body(i, carry):
            # the last window clamps to the aligned head; its start
            # stays chunk-aligned (n_al and w_rows are both multiples),
            # so re-covered chunks rewrite the SAME sums (idempotent —
            # and OR over re-covered rows is idempotent for anyp too)
            acc, ap = carry
            start = jnp.minimum(i * w_rows, n_al - w_rows)
            v = jax.lax.dynamic_slice(vals, (start,), (w_rows,))
            c = window_weights(start, w_rows)
            if also_any_positive:
                ap = ap | jnp.any(c > 0)
            ch_w = _channel_sums(v, c, chunk)
            return (jax.lax.dynamic_update_slice(acc, ch_w,
                                                 (0, start // chunk)), ap)
        acc0 = jnp.zeros((5, m), jnp.int32)
        ap0 = jnp.array(False)
        if vary_axis is not None:
            acc0 = jax.lax.pcast(acc0, vary_axis, to="varying")
            ap0 = jax.lax.pcast(ap0, vary_axis, to="varying")
        ch, anyp = jax.lax.fori_loop(0, nw, body, (acc0, ap0))
        if not also_any_positive:
            anyp = None
        if n_al < n:
            # ragged tail: fold the LAST chunk of rows, masking the
            # part already covered by the aligned head
            live_from = np.int32(n_al - (n - chunk))
            v = jax.lax.dynamic_slice(vals, (n - chunk,), (chunk,))
            c = window_weights(np.int32(n - chunk), chunk)
            if also_any_positive:
                idx = jax.lax.broadcasted_iota(jnp.int32, c.shape, 0)
                anyp = anyp | jnp.any((idx >= live_from) & (c > 0))
            tail = _channel_sums(v, c, chunk, live_from=live_from)
            ch = jnp.concatenate([ch, tail], axis=1)
    lo = (ch & 0x7FF).sum(axis=1, dtype=jnp.int32)
    mid = ((ch >> SEG_SHIFT) & 0x7FF).sum(axis=1, dtype=jnp.int32)
    hi = (ch >> (2 * SEG_SHIFT)).sum(axis=1, dtype=jnp.int32)
    fold = jnp.stack([lo, mid, hi], axis=-1)        # (5, 3)
    return (fold, anyp) if also_any_positive else fold


_W_WEIGHTS = (1, 1 << 16, 1 << 16, 1 << 32, 1 << 32)


def combine_weighted_partials(partials: np.ndarray) -> int:
    """Host half: exact u64 (wrapping) total of weighted_partials output
    (folded (5, 2) channels)."""
    p = np.asarray(partials)
    total = 0
    for ch, w in zip(p, _W_WEIGHTS):
        total += _rowsum(ch) * w
    return total & _U64_MASK


def combine_weighted_segments(partials: np.ndarray) -> int:
    """Host half of weighted_partials_segments (one (5, 3) row): like
    combine_weighted_partials but with SEG_SHIFT=11 3-piece decoding."""
    p = np.asarray(partials)
    total = 0
    for ch, w in zip(p, _W_WEIGHTS):
        total += (int(ch[..., 0]) + (int(ch[..., 1]) << SEG_SHIFT)
                  + (int(ch[..., 2]) << (2 * SEG_SHIFT))) * w
    return total & _U64_MASK
