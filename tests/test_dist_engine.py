"""Engine-level distributed execution on the 8-virtual-device CPU mesh:
full query semantics vs the oracle, Zipf skew through the heavy path, wide
values, and the golden workload (SURVEY.md §4 multi-chip test plan).
"""

import numpy as np
import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.models.engine import Engine
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.parallel import DistExecutor
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)

from test_fuzz import _random_catalog, _random_query
from test_wide import _wide_catalog, _wide_filter_query

# SPMD CPU compiles dominate; deselected from the default run
pytestmark = pytest.mark.slow


def _check(rels, queries, config=None):
    oracle = OracleExecutor(rels)
    ex = DistExecutor(rels, config or EngineConfig(), n_devices=8)
    for q in queries:
        got = format_result(ex.execute(q), len(q.projections))
        exp = format_result(oracle.execute(q), len(q.projections))
        assert got == exp, (q, got, exp)
    return ex


# factorized=True exercises the distributed ftree (d_ftree: psum'd
# message tables); factorized=False forces the exchange machinery
# (all_to_all / broadcast joins) the ftree would otherwise shadow
@pytest.mark.parametrize("fact", [True, False])
@pytest.mark.parametrize("seed", range(2))
def test_dist_fuzz_matches_oracle(seed, fact):
    rng = np.random.default_rng(3000 + seed)
    rels = _random_catalog(rng)
    _check(rels, [_random_query(rng, rels) for _ in range(6)],
           EngineConfig(factorized=fact))


def test_dist_zipf_skew_heavy_path():
    # one key owns ~60% of both sides: its digit is globally heavy, so the
    # broadcast path MUST engage (an all_to_all-only design would need a
    # per-destination capacity of nearly the whole relation)
    rng = np.random.default_rng(42)
    n = 4096
    heavy_key = 24                     # digit 0 on an 8-chip mesh
    k1 = np.where(rng.random(n) < 0.6, heavy_key,
                  rng.integers(0, 500, n)).astype(np.uint64)
    k2 = np.where(rng.random(n) < 0.6, heavy_key,
                  rng.integers(0, 500, n)).astype(np.uint64)
    rels = [Relation([k1, rng.integers(0, 100, n).astype(np.uint64)]),
            Relation([k2, rng.integers(0, 100, n).astype(np.uint64)])]
    # factorized=False: the join must go through the skew-aware exchange
    cfg = EngineConfig(skew_heavy_fraction=0.25, factorized=False)
    digit_share = (k2 % 8 == heavy_key % 8).mean()
    assert digit_share > cfg.skew_heavy_fraction   # heavy path engaged
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)],
              [FilterPred(0, 1, "<", 90)],
              [Projection(0, 1), Projection(1, 1)])
    ex = _check(rels, [q], cfg)
    assert ex.counters["exchange_queries"] == 1


@pytest.mark.parametrize("fact", [True, False])
def test_dist_wide_values(fact):
    rng = np.random.default_rng(11)
    rels = _wide_catalog(rng)
    queries = [_wide_filter_query(rng, rels, _random_query(rng, rels))
               for _ in range(4)]
    _check(rels, queries, EngineConfig(factorized=fact))


def test_dist_ftree_corners():
    """Distributed factorized corners: relations smaller than the mesh,
    row counts not divisible by 8 (pad/duplicate-row validity masks),
    trailing join-born selection (psum'd support-intersection NULL
    gate), and a case-1-wiped component (boolean flag tree)."""
    A = Relation([np.array([1, 2, 5], np.uint64),
                  np.array([2, 9, 9], np.uint64)])       # 3 rows < 8 chips
    B = Relation([np.arange(13, dtype=np.uint64) % 4,
                  np.arange(13, dtype=np.uint64)])       # 13 % 8 != 0
    C = Relation([np.array([2, 2, 3], np.uint64)])
    queries = [
        # tree join, uneven shards
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 1), Projection(1, 1)]),
        # trailing join-born sel, pair set nonempty ({2}) but zero rows
        # survive -> zeros, NOT NULL
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 1)]),
        # trailing join-born sel, pair set EMPTY ({9} vs {2}) -> NULL
        Query([2, 0], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 0, 0)],
              [], [Projection(0, 0)]),
        # case-1 wipe: first comp survives only as a NULL gate
        Query([0, 1, 2, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [FilterPred(0, 1, ">", 1)],
              [Projection(2, 0), Projection(0, 0)]),
    ]
    ex = _check([A, B, C], queries)
    assert ex.counters["ftree_queries"] == len(queries)


def test_dist_composite_key_fusion():
    """A non-trailing parallel edge fuses into a composite key
    (DeviceCatalog.edge_key pair dictionary) — the synthesized key
    columns must row-shard and psum exactly like native columns."""
    rng = np.random.default_rng(77)
    n = 300
    a0 = rng.integers(0, 20, n).astype(np.uint64)
    a1 = rng.integers(0, 20, n).astype(np.uint64)
    A = Relation([a0, a1, rng.integers(0, 100, n).astype(np.uint64)])
    B = Relation([a0.copy(), a1.copy(),
                  rng.integers(0, 100, n).astype(np.uint64)])
    rng.shuffle(B.values[0])           # decorrelate but keep the domain
    C = Relation([np.arange(100, dtype=np.uint64)])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
               JoinPred(1, 2, 2, 0)],
              [], [Projection(0, 2), Projection(2, 0)])
    ex = _check([A, B, C], [q])
    assert ex.counters["ftree_queries"] == 1


def test_dist_trailing_composite_fusion_gate():
    """A TRAILING parallel edge factorizes via the fused-spec +
    boolean-companion pair; the cross-node support-intersection gate
    must psum across chips (a value can participate on one chip and
    match on another). Three variants: sums, zeros-not-NULL (pair set
    non-empty but fused multiset empty), and NULL (pair set empty)."""
    rng = np.random.default_rng(91)
    n = 600
    a0 = rng.integers(0, 30, n).astype(np.uint64)
    a1 = rng.integers(0, 30, n).astype(np.uint64)
    A = Relation([a0, a1, rng.integers(0, 100, n).astype(np.uint64)])
    B_sum = Relation([a0.copy(), a1.copy(),
                      rng.integers(0, 100, n).astype(np.uint64)])
    # zeros-not-NULL: shift col1 so no aligned pair matches but the
    # value domains (and the joined col0 rows) still intersect
    B_zero = Relation([np.array([0, 1], np.uint64),
                       np.array([5, 4], np.uint64)])
    A_zero = Relation([np.array([0, 1], np.uint64),
                       np.array([4, 5], np.uint64)])
    B_null = Relation([np.array([0, 1], np.uint64),
                       np.array([1000, 1001], np.uint64)])
    rels = [A, B_sum, A_zero, B_zero, B_null]
    q_tmpl = lambda s1, s2: Query(
        [s1, s2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
        [], [Projection(0, 0), Projection(1, 1)])
    ex = _check(rels, [q_tmpl(0, 1), q_tmpl(2, 3), q_tmpl(2, 4)])
    assert ex.counters["ftree_queries"] == 3


def test_dist_wave_one_dispatch_per_batch():
    """run_batch merges every factorizable query of a batch into ONE
    d_ftree wave program (one dispatch + one readback on a real pod);
    non-factorizable queries still run through the exchange pipeline.
    Results must equal the oracle's exactly, including a NULL row."""
    rng = np.random.default_rng(500)
    rels = _random_catalog(rng)
    batch = [_random_query(rng, rels) for _ in range(5)]
    # a self-join-free two-slot tree query guaranteed factorizable
    batch.append(Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                       [Projection(0, 0), Projection(1, 0)]))
    oracle = OracleExecutor(rels)
    ex = DistExecutor(rels, EngineConfig(), n_devices=8)
    got = ex.run_batch(batch)
    exp = [format_result(oracle.execute(q), len(q.projections))
           for q in batch]
    assert got == exp
    assert ex.counters["ftree_queries"] >= 1
    assert ex.counters["ftree_waves"] == 1


def test_dist_engine_facade(small_catalog, small_batches, golden_lines):
    # Engine(config.mesh_devices) routes through the distributed executor;
    # batch 1 of the golden workload exact-matches
    eng = Engine(small_catalog, EngineConfig(mesh_devices=8))
    assert eng.dist_executor is not None
    got = eng.run_batch(small_batches[0])
    assert got == golden_lines[:len(small_batches[0])]


def test_dist_golden_full(small_catalog, small_batches, golden_lines):
    eng = Engine(small_catalog, EngineConfig(mesh_devices=8))
    got = eng.run_workload(small_batches)
    assert got == golden_lines


def test_columns_are_row_sharded_not_replicated():
    """The distributed catalog must hold ~1/N of each column per chip
    (round-3 layout: NamedSharding(mesh, P(axis)) columns), not a replica.
    Also checks ownership alignment: d_seed's rowid ranges equal the
    column shard ranges."""
    n_dev = 8
    rows = 1 << 15                         # large enough to out-bucket pad
    rng = np.random.default_rng(7)
    rel = Relation([rng.integers(0, 1000, rows).astype(np.uint64),
                    rng.integers(0, 1000, rows).astype(np.uint64)])
    ex = DistExecutor([rel], EngineConfig(), n_devices=n_dev)
    col = ex.catalog.col(0, 0)
    cap = ex.catalog.shard_cap(0)
    assert cap == 1 << 12                  # bucket(ceil(2^15 / 8))
    assert col.shape[0] == n_dev * cap
    shard_bytes = [s.data.nbytes for s in col.addressable_shards]
    assert len(shard_bytes) == n_dev
    # each chip holds exactly 1/N of the (padded) column — replication
    # would put col.nbytes on every shard
    assert all(b == col.nbytes // n_dev for b in shard_bytes)
    # projection planes shard the same way
    plane, _ = ex.catalog.proj_planes(0, 1)[0]
    assert plane.addressable_shards[0].data.nbytes == plane.nbytes // n_dev
    # the query still answers exactly against the oracle
    q = Query([0, 0], [JoinPred(0, 0, 1, 1)], [FilterPred(0, 1, "<", 500)],
              [Projection(0, 1)])
    got = format_result(ex.execute(q), 1)
    exp = format_result(OracleExecutor([rel]).execute(q), 1)
    assert got == exp


def test_dist_lazy_star_huge_shards(monkeypatch):
    """Huge PER-CHIP shards through d_ftree: with the thresholds shrunk,
    every node column shard crosses _BIG_WAVE_ROWS, so the distributed
    wave runs the lazy machinery — and every shard carries a validity
    MASK (the r3 gap: masked lazy folds used to materialize). Star
    shape: the fact shard's beta is a lazy product; folds, down-pass
    scatters, and the psum'd windowed-OR flag all stay O(window)."""
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 512)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(77)
    n = 8 * 700 + 33                     # ~700 rows/chip > 512
    fact = Relation([rng.integers(0, 100, n).astype(np.uint64),
                     rng.integers(0, 80, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    d1 = Relation([np.arange(100, dtype=np.uint64),
                   rng.integers(0, 1000, 100).astype(np.uint64)])
    d2 = Relation([np.arange(80, dtype=np.uint64),
                   rng.integers(0, 1000, 80).astype(np.uint64)])
    rels = [fact, d1, d2]
    star = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
    queries = [
        Query([0, 1, 2], star, [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(0, 2, "<", 700)],
              [Projection(0, 2), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "=", 55555)],
              [Projection(0, 2)]),
    ]
    ex = _check(rels, queries)
    assert ex.counters["ftree_queries"] == len(queries)


def test_dist_gather_capacity_retry(monkeypatch):
    """Histogram-sized _dist_gather capacity, end to end: a forced tiny
    initial capacity makes the bounded request matrix overflow on real
    ownership skew, and the verify-and-retry ladder (x4 steps, worst
    case last) must recover the exact answer — never a silent drop.
    Covers d_eq_mat (case 3 + NULL gate), d_case2_probe, d_project."""
    monkeypatch.setattr(DistExecutor, "_gather_cap", lambda self, m: 8)
    rng = np.random.default_rng(91)
    n = 3000
    rels = [Relation([rng.integers(0, 40, n).astype(np.uint64),
                      rng.integers(0, 40, n).astype(np.uint64),
                      rng.integers(0, 100, n).astype(np.uint64)]),
            Relation([rng.integers(0, 40, 500).astype(np.uint64),
                      rng.integers(0, 100, 500).astype(np.uint64)])]
    queries = [
        # case 1 -> case 3 (d_eq_mat, pair-set NULL gate) -> projections
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 2), Projection(1, 1)]),
        # case 1 -> case 2 (d_case2_probe broadcast join) -> projection
        Query([0, 1, 0],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(2, 2, "<", 80)], [Projection(2, 2)]),
    ]
    cfg = EngineConfig(factorized=False)   # force the exchange pipeline
    ex = _check(rels, queries, cfg)
    assert ex.counters["gather_retries"] > 0


def test_dist_broadcast_chunks_match_unchunked():
    """The chunked case-2 fresh broadcast / case-3 pair-set test
    (broadcast_chunks > 1: (n_chips, width/K) transients, per-chunk
    expansion at running offsets) answers identically to the unchunked
    path on queries driving every consumer — case 2 expansion order
    differs per lane, but the multiset (and thus every SUM) must not."""
    rng = np.random.default_rng(17)
    n = 2000
    rels = [Relation([rng.integers(0, 30, n).astype(np.uint64),
                      rng.integers(0, 30, n).astype(np.uint64),
                      rng.integers(0, 100, n).astype(np.uint64)]),
            Relation([rng.integers(0, 30, 700).astype(np.uint64),
                      rng.integers(0, 100, 700).astype(np.uint64)])]
    queries = [
        # case 1 -> case 2 (fresh broadcast, filtered) -> projections
        Query([0, 1, 0],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(2, 2, "<", 60)],
              [Projection(2, 2), Projection(1, 1)]),
        # case 1 -> case 3 (pair-set NULL gate over live values)
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 2), Projection(1, 1)]),
        # pair set EMPTY -> NULL must survive chunking of the test
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 2, 1, 1)],
              [], [Projection(0, 2)]),
    ]
    outs = {}
    for k in (1, 4):
        cfg = EngineConfig(factorized=False, broadcast_chunks=k)
        ex = DistExecutor(rels, cfg, n_devices=8)
        outs[k] = [ex.execute(q) for q in queries]
    assert outs[1] == outs[4]
    oracle = OracleExecutor(rels)
    for q, got in zip(queries, outs[4]):
        want = oracle.execute(q)
        assert (got is None) == (want is None)
        if got is not None:
            assert [s & ((1 << 64) - 1) for s in want] == [
                s & ((1 << 64) - 1) for s in got]


def test_dist_exchange_capacity_retry(monkeypatch):
    """Histogram-sized case-1 EXCHANGE capacity (d_case1_probe ecap),
    end to end: a forced tiny capacity truncates the bounded right/left
    exchange bins and the heavy-broadcast prefix under key skew, the
    probe's exchange-overflow stat fires, and the verify-and-retry
    ladder must recover the exact answer — never a silent drop."""
    monkeypatch.setattr(DistExecutor, "_gather_cap", lambda self, m: 8)
    rng = np.random.default_rng(92)
    n = 3000
    # one dominant key (heavy digit -> the packed broadcast prefix
    # overflows cap 8) plus a skewed light tail (bins overflow too)
    ka = np.where(rng.random(n) < 0.5, 7,
                  rng.integers(0, 40, n)).astype(np.uint64)
    rels = [Relation([ka, rng.integers(0, 100, n).astype(np.uint64)]),
            Relation([rng.integers(0, 40, 500).astype(np.uint64),
                      rng.integers(0, 100, 500).astype(np.uint64)])]
    queries = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                     [Projection(0, 1), Projection(1, 1)])]
    cfg = EngineConfig(factorized=False)   # force the exchange pipeline
    ex = _check(rels, queries, cfg)
    assert ex.counters["gather_retries"] > 0


def test_dist_huge_shards(monkeypatch):
    """Huge-node window loops INSIDE shard_map: each chip walks the
    windows of its own shard, shard validity masks zero the pad rows,
    and one psum per level makes the message tables global. Exact vs
    the oracle on the 8-virtual-device mesh."""
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 512)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(78)
    n = 8 * 700 + 33
    fact = Relation([rng.integers(0, 100, n).astype(np.uint64),
                     rng.integers(0, 80, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    d1 = Relation([np.arange(100, dtype=np.uint64),
                   rng.integers(0, 1000, 100).astype(np.uint64)])
    d2 = Relation([np.arange(80, dtype=np.uint64),
                   rng.integers(0, 1000, 80).astype(np.uint64)])
    rels = [fact, d1, d2]
    star = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 2), Projection(1, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(0, 2, "<", 700)],
              [Projection(0, 2), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "=", 55555)],
              [Projection(0, 2)]),
    ]
    ex = _check(rels, queries, EngineConfig())
    assert ex.counters["ftree_queries"] == len(queries)
