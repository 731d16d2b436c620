"""Distributed radix-exchange join on the 8-virtual-device CPU mesh.

The reference has zero distributed tests (it has zero distributed anything,
SURVEY.md §5); this is the multi-chip coverage the mesh design requires.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest

from radixhashjoin_tpu.parallel import (dist_join_count_sum,
                                        dist_join_skewaware, make_mesh)

# SPMD CPU compiles dominate (minutes); deselected from the default run
pytestmark = pytest.mark.slow


def _oracle(lv, rv):
    cnt = collections.Counter(rv.tolist())
    pairs = sum(cnt[x] for x in lv.tolist())
    total = sum(cnt[x] * x for x in lv.tolist())
    return pairs, total


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_dist_join_matches_oracle(mesh):
    rng = np.random.default_rng(0)
    n = 8 * 512
    lv = rng.integers(0, 200, n).astype(np.int32)
    rv = rng.integers(0, 200, n).astype(np.int32)
    counts = jnp.asarray(np.full(8, 512, dtype=np.int32))
    pairs, lo, hi, ovf = dist_join_count_sum(
        mesh, jnp.asarray(lv), counts, jnp.asarray(rv), counts, capacity=512)
    exp_pairs, exp_sum = _oracle(lv, rv)
    assert int(pairs) == exp_pairs
    assert int(lo) + (int(hi) << 16) == exp_sum
    assert int(ovf) == 0


def test_dist_join_ragged_live_counts(mesh):
    # shards with different live prefixes: dead lanes must not join
    rng = np.random.default_rng(1)
    n = 8 * 256
    lv = rng.integers(0, 50, n).astype(np.int32)
    rv = rng.integers(0, 50, n).astype(np.int32)
    lcounts = np.array([256, 100, 0, 256, 17, 200, 256, 1], dtype=np.int32)
    rcounts = np.array([256, 256, 256, 0, 256, 3, 250, 256], dtype=np.int32)
    live_l = np.concatenate([lv[i * 256:i * 256 + c]
                             for i, c in enumerate(lcounts)])
    live_r = np.concatenate([rv[i * 256:i * 256 + c]
                             for i, c in enumerate(rcounts)])
    pairs, lo, hi, ovf = dist_join_count_sum(
        mesh, jnp.asarray(lv), jnp.asarray(lcounts),
        jnp.asarray(rv), jnp.asarray(rcounts), capacity=256)
    exp_pairs, exp_sum = _oracle(live_l, live_r)
    assert int(pairs) == exp_pairs
    assert int(lo) + (int(hi) << 16) == exp_sum
    assert int(ovf) == 0


def test_dist_join_overflow_detected(mesh):
    # all rows share one key -> one destination digit overflows its capacity
    n = 8 * 64
    lv = np.full(n, 8, dtype=np.int32)  # digit 0 everywhere
    rv = np.full(n, 8, dtype=np.int32)
    counts = jnp.asarray(np.full(8, 64, dtype=np.int32))
    *_, ovf = dist_join_count_sum(
        mesh, jnp.asarray(lv), counts, jnp.asarray(rv), counts, capacity=16)
    assert int(ovf) > 0  # skew signal: caller must take the skew path


def test_skewaware_handles_dominant_key(mesh):
    # one key owns most rows: the plain exchange would overflow capacity;
    # the skew-aware join must stay exact with zero light-path overflow
    rng = np.random.default_rng(7)
    n = 8 * 256
    lv = rng.integers(0, 50, n).astype(np.int32)
    rv = rng.integers(0, 50, n).astype(np.int32)
    rv[: n // 2] = 8   # dominant key -> digit 0 is heavy
    counts = jnp.asarray(np.full(8, 256, dtype=np.int32))
    pairs, lo, hi, ovf = dist_join_skewaware(
        mesh, jnp.asarray(lv), counts, jnp.asarray(rv), counts,
        capacity=256, heavy_fraction=0.25)
    exp_pairs, exp_sum = _oracle(lv, rv)
    assert int(ovf) == 0
    assert int(pairs) == exp_pairs
    assert int(lo) + (int(hi) << 16) == exp_sum


def test_skewaware_uniform_matches_plain(mesh):
    rng = np.random.default_rng(9)
    n = 8 * 256
    lv = rng.integers(0, 500, n).astype(np.int32)
    rv = rng.integers(0, 500, n).astype(np.int32)
    counts = jnp.asarray(np.full(8, 256, dtype=np.int32))
    pairs, lo, hi, ovf = dist_join_skewaware(
        mesh, jnp.asarray(lv), counts, jnp.asarray(rv), counts,
        capacity=256)
    exp_pairs, exp_sum = _oracle(lv, rv)
    assert int(pairs) == exp_pairs and int(ovf) == 0
    assert int(lo) + (int(hi) << 16) == exp_sum


def test_dist_gather_chunked_matches_unchunked(mesh):
    """Chunked _dist_gather (K request/response sub-exchanges bounding
    the (n, m/K) transient) must return exactly the unchunked answer for
    skewed ownership (all requests hitting one chip) and random global
    rowids, above and below the 4096-lane chunking floor. A bounded
    per-destination capacity (histogram-sized transient) must answer
    identically when it holds, and raise the overflow flag — never
    silently drop — when ownership skew exceeds it."""
    import jax
    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from radixhashjoin_tpu.parallel.dist_ops import _dist_gather

    n = 8
    cap = 4096
    rng = np.random.default_rng(3)
    col = rng.integers(0, 2**31 - 1, n * cap).astype(np.int32)

    @partial(jax.jit, static_argnames=("m", "chunks", "gcap"))
    def run(col, idxs, live, m, chunks, gcap=0):
        @partial(shard_map, mesh=mesh, in_specs=(P("x"), P(), P()),
                 out_specs=(P("x", None), P("x")))
        def body(col, idxs, live):
            v, o = _dist_gather(col, idxs, live, "x", n, chunks, gcap)
            return v[None], o.reshape(1)
        return body(col, idxs, live)

    for m, skewed in ((1 << 15, False), (1 << 15, True), (1 << 10, False)):
        if skewed:     # every request owned by chip 3: worst-case skew
            idxs = rng.integers(3 * cap, 4 * cap, m).astype(np.int32)
        else:
            idxs = rng.integers(0, n * cap, m).astype(np.int32)
        live = rng.random(m) < 0.9
        want = np.where(live, col[idxs], 0)
        base, _ = run(jnp.asarray(col), jnp.asarray(idxs),
                      jnp.asarray(live), m, 1)
        base = np.asarray(base)
        chunk, _ = run(jnp.asarray(col), jnp.asarray(idxs),
                       jnp.asarray(live), m, 8)
        chunk = np.asarray(chunk)
        for shard in range(n):      # every chip computes the same answer
            np.testing.assert_array_equal(
                np.where(live, base[shard], 0), want)
            np.testing.assert_array_equal(chunk[shard], base[shard])
        # uniform ownership fits a 2x-share capacity: identical answer,
        # no overflow; worst-case skew overflows it LOUDLY on the owner
        gcap = max(2 * m // n, 1024)
        vals, ovf = run(jnp.asarray(col), jnp.asarray(idxs),
                        jnp.asarray(live), m, 1, gcap)
        vals, ovf = np.asarray(vals), np.asarray(ovf)
        if skewed:
            assert ovf.any(), (m, gcap)
        else:
            assert not ovf.any(), (m, gcap)
            for shard in range(n):
                np.testing.assert_array_equal(vals[shard], base[shard])


def test_case1_expand_capacity_tight_vs_slack(mesh):
    """d_case1_expand's pair buffer is count-then-materialize sized
    (out_cap = bucket of the probe's measured max per-chip total): the
    TIGHT capacity (exactly the bucketed max) and a 4x slack one must
    yield the same pair multiset — lanes past each chip's total are
    garbage by contract and must be masked by the per-shard counts
    (expand-capacity coverage)."""
    import collections
    from radixhashjoin_tpu.parallel.dist_ops import (d_case1_probe,
                                                     d_case1_expand,
                                                     d_seed)
    rng = np.random.default_rng(7)
    n = 8 * 512
    colA = jnp.asarray(rng.integers(0, 300, n).astype(np.int32))
    colB = jnp.asarray(rng.integers(0, 300, n).astype(np.int32))
    lrows, lcnts = d_seed(mesh, "x", n, 512)
    rrows, rcnts = d_seed(mesh, "x", n, 512)
    out = d_case1_probe(mesh, "x", 0.1, 1, colA, colB,
                        lrows, lcnts, rrows, rcnts)
    Lrow, Rrow, order, lo, off, cum, totals, stats = out
    assert int(np.asarray(stats)[2]) == 0
    mx = int(np.asarray(totals).max())
    av, bv = np.asarray(colA), np.asarray(colB)
    want = collections.Counter()
    # oracle pair multiset as (a-rowid, b-rowid) pairs
    by_val = collections.defaultdict(list)
    for j, b in enumerate(bv.tolist()):
        by_val[b].append(j)
    for i, a in enumerate(av.tolist()):
        for j in by_val.get(a, ()):
            want[(i, j)] += 1
    tot_np = np.asarray(totals)
    tight = 1 << max(mx - 1, 1).bit_length()     # bucketed max total
    for cap in (tight, tight * 4):
        mat = np.asarray(d_case1_expand(mesh, "x", cap, Lrow, Rrow,
                                        order, lo, off, cum))
        got = collections.Counter()
        for chip in range(8):
            t = int(tot_np[chip])
            for k in range(t):
                got[(int(mat[0, chip * cap + k]),
                     int(mat[1, chip * cap + k]))] += 1
        assert got == want, f"cap={cap}"
