"""Unit tests of the device operators against NumPy oracles.

This is the per-kernel coverage the reference entirely lacks (SURVEY.md §4):
compaction, filters, join count/expand, membership, exact u64 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from radixhashjoin_tpu.ops.aggregate import sum_column_over_rows
from radixhashjoin_tpu.ops.compact import compact, compact_mask_positions
from radixhashjoin_tpu.ops.filter import OP_CODE, filter_live
from radixhashjoin_tpu.ops.join import any_common, expand_pairs, probe_count
from radixhashjoin_tpu.utils.padding import bucket_size, pad_to


def test_bucket_size():
    assert bucket_size(0) == 1024
    assert bucket_size(1024) == 1024
    assert bucket_size(1025) == 2048
    assert bucket_size(3_000_000) == 4194304


def test_compact_stable():
    arr = jnp.arange(1024, dtype=jnp.int32) * 10
    mask = (jnp.arange(1024) % 3) == 0
    pos, cnt = compact_mask_positions(mask)
    out = np.asarray(compact(arr, pos))
    expect = np.arange(0, 1024, 3) * 10
    assert int(cnt) == len(expect)
    np.testing.assert_array_equal(out[:len(expect)], expect)


@pytest.mark.parametrize("op,ref", [("=", np.equal), ("<", np.less),
                                    (">", np.greater)])
def test_filter_live(op, ref):
    rng = np.random.default_rng(1)
    n, pad = 700, 1024
    col = rng.integers(0, 50, 2000).astype(np.int32)
    rows = rng.choice(2000, n, replace=False).astype(np.int32)
    k = 25
    got_rows, got_cnt = filter_live(
        jnp.asarray(pad_to(rows, pad, 0)), jnp.int32(n),
        jnp.asarray(col), jnp.int32(k), OP_CODE[op])
    expect = rows[ref(col[rows], k)]
    assert int(got_cnt) == len(expect)
    np.testing.assert_array_equal(np.asarray(got_rows)[:len(expect)], expect)


def _oracle_pairs(lv, rv):
    """All (i, j) with lv[i] == rv[j], grouped by i, j ascending within i."""
    out = []
    for i, x in enumerate(lv):
        for j, y in enumerate(rv):
            if x == y:
                out.append((i, j))
    return out


def test_join_count_expand_exact():
    rng = np.random.default_rng(2)
    L, R = 300, 500
    lv = rng.integers(0, 40, L).astype(np.int32)
    rv = rng.integers(0, 40, R).astype(np.int32)
    lpad = pad_to(lv, 1024, 0)
    rpad = pad_to(rv, 1024, 0)
    order, lo, off, cum, total = probe_count(
        jnp.asarray(lpad), jnp.int32(L), jnp.asarray(rpad), jnp.int32(R))
    expect = _oracle_pairs(lv, rv)
    assert int(total) == len(expect)
    out_size = bucket_size(int(total))
    li, ri = expand_pairs(order, lo, off, cum, out_size)
    got = sorted(zip(np.asarray(li)[:len(expect)].tolist(),
                     np.asarray(ri)[:len(expect)].tolist()))
    assert got == sorted(expect)


def test_join_no_match_and_sentinels():
    lv = pad_to(np.array([1, 2, 3], dtype=np.int32), 1024, 0)
    rv = pad_to(np.array([7, 8], dtype=np.int32), 1024, 0)
    *_, total = probe_count(jnp.asarray(lv), jnp.int32(3),
                            jnp.asarray(rv), jnp.int32(2))
    assert int(total) == 0
    # padding lanes (value 0 on both sides) must not fabricate matches
    lv2 = pad_to(np.array([0, 5], dtype=np.int32), 1024, 0)
    rv2 = pad_to(np.array([0, 0, 6], dtype=np.int32), 1024, 0)
    *_, t2 = probe_count(jnp.asarray(lv2), jnp.int32(2),
                         jnp.asarray(rv2), jnp.int32(3))
    assert int(t2) == 2  # only the live 0 matches the two live 0s


def test_any_common():
    a = pad_to(np.array([1, 2, 3], dtype=np.int32), 1024, 0)
    b = pad_to(np.array([9, 3, 9], dtype=np.int32), 1024, 0)
    assert bool(any_common(jnp.asarray(a), jnp.asarray(b), jnp.int32(3)))
    b2 = pad_to(np.array([9, 9, 9], dtype=np.int32), 1024, 0)
    assert not bool(any_common(jnp.asarray(a), jnp.asarray(b2), jnp.int32(3)))
    # live prefix only: the 3 in b beyond count must not count
    assert not bool(any_common(jnp.asarray(a), jnp.asarray(b), jnp.int32(1)))


def test_sum_exact_u64_over_2_32():
    # sums must exceed 2**32 exactly (BASELINE.md: e.g. 5032407477)
    n = 5000
    col = jnp.full(8192, 2**20, dtype=jnp.int32)
    rows = jnp.arange(8192, dtype=jnp.int32)
    got = sum_column_over_rows(col, rows, jnp.int32(n))
    assert got == n * 2**20 > 2**32


def test_sum_masks_padding():
    col = jnp.asarray(np.arange(4096, dtype=np.int32))
    rows = jnp.asarray(pad_to(np.array([1, 2, 3], dtype=np.int32), 1024, 999))
    assert sum_column_over_rows(col, rows, jnp.int32(3)) == 6


# ---- message tables (ops/tables.py) ----

@pytest.mark.parametrize("n_bins", [7, 700, 1 << 16])
def test_scatter_table_matches_numpy(n_bins):
    """Weighted bincount: masked rows carry the n_bins sentinel and drop;
    weights reach past 2**16, per-bin totals stay below 2**31 (the
    planner's overflow caps, models/batch.py:_ftree_caps)."""
    from radixhashjoin_tpu.ops.tables import scatter_add
    rng = np.random.default_rng(5)
    n = 5000
    idx = np.where(rng.random(n) < 0.1, n_bins,
                   rng.integers(0, n_bins, n)).astype(np.int32)
    w = rng.integers(0, 2**20, n).astype(np.int32)
    live = idx < n_bins
    want = np.bincount(idx[live], weights=w[live].astype(np.float64),
                       minlength=n_bins).astype(np.int64)
    got = np.asarray(scatter_add(jnp.zeros(n_bins, jnp.int32),
                                 jnp.asarray(idx), jnp.asarray(w)))
    assert (got == want).all()


def test_scatter_add_window_accumulates():
    """One window of a huge build adds into a nonzero accumulator and
    drops the masked-row sentinel (idx == n_bins)."""
    from radixhashjoin_tpu.ops.tables import scatter_add_window
    rng = np.random.default_rng(11)
    n, n_bins = 8192, 1 << 14
    idx = rng.integers(0, n_bins, n).astype(np.int32)
    idx[::7] = n_bins
    w = rng.integers(0, 1000, n).astype(np.int32)
    acc0 = rng.integers(0, 50, n_bins).astype(np.int32)
    want = acc0.astype(np.int64).copy()
    np.add.at(want, idx[idx < n_bins], w[idx < n_bins])
    got = np.asarray(scatter_add_window(jnp.asarray(acc0), jnp.asarray(idx),
                                        jnp.asarray(w)))
    assert (got == want).all()


def _hot_keys(rng, n, n_bins, share):
    """n keys in [0, n_bins) with key 3 forced on `share` of the rows,
    and the masked-row sentinel (n_bins) on every 9th row."""
    idx = rng.integers(0, n_bins, n).astype(np.int32)
    idx[rng.random(n) < share] = 3
    idx[::9] = n_bins
    return idx


@pytest.mark.parametrize("share,hot", [(0.0, False), (0.05, False),
                                       (0.25, True), (0.9, True)])
def test_hot_key_rule(share, hot):
    from radixhashjoin_tpu.ops.tables import hot_key
    idx = _hot_keys(np.random.default_rng(12), 1 << 16, 1 << 10, share)
    assert bool(hot_key(jnp.asarray(idx), 1 << 10)) == hot


def test_hot_key_ignores_the_sentinel():
    """A window of mostly masked rows (sentinel n_bins) is not hot."""
    from radixhashjoin_tpu.ops.tables import hot_key
    idx = np.full(1 << 14, 1 << 10, np.int32)
    idx[::5] = np.arange(idx[::5].size) % (1 << 10)
    assert not bool(hot_key(jnp.asarray(idx), 1 << 10))


@pytest.mark.parametrize("share", [0.0, 0.3])
def test_scatter_add_window_either_branch_exact(share):
    """Both branches of the window build (scatter-add, and the sorted
    build a hot key selects) match numpy, accumulating into acc."""
    from radixhashjoin_tpu.ops.tables import scatter_add_window
    rng = np.random.default_rng(13)
    n, n_bins = 1 << 15, 1 << 12
    idx = _hot_keys(rng, n, n_bins, share)
    w = rng.integers(0, 1 << 12, n).astype(np.int32)
    acc0 = rng.integers(0, 50, n_bins).astype(np.int32)
    want = acc0.astype(np.int64).copy()
    np.add.at(want, idx[idx < n_bins], w[idx < n_bins])
    got = np.asarray(scatter_add_window(jnp.asarray(acc0), jnp.asarray(idx),
                                        jnp.asarray(w)))
    assert (got == want).all()


def test_weighted_bincount_sorted_exact_past_int32_total():
    """The sorted build's int32 cumsum wraps once the weights' total
    passes 2**31; every bin sum stays below it, so the wrapped
    differences are still exact."""
    from radixhashjoin_tpu.ops.tables import weighted_bincount_sorted
    rng = np.random.default_rng(14)
    n, n_bins = 4096, 256
    idx = rng.integers(0, n_bins + 1, n).astype(np.int32)   # + sentinel
    w = rng.integers(0, 1 << 22, n).astype(np.int32)
    assert w.astype(np.int64).sum() > 2**31
    live = idx < n_bins
    want = np.bincount(idx[live], weights=w[live].astype(np.float64),
                       minlength=n_bins).astype(np.int64)
    assert want.max() < 2**31
    got = np.asarray(weighted_bincount_sorted(jnp.asarray(idx),
                                              jnp.asarray(w), n_bins))
    assert (got == want).all()


def test_table_gather_exact_full_int32():
    from radixhashjoin_tpu.ops.tables import table_gather
    rng = np.random.default_rng(6)
    table = rng.integers(-2**31, 2**31 - 1, 512, dtype=np.int64).astype(
        np.int32)
    keys = rng.integers(0, 512, 4096).astype(np.int32)
    got = np.asarray(table_gather(jnp.asarray(table), jnp.asarray(keys)))
    assert (got == table[keys]).all()
