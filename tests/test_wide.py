"""Full-u64 device path: the order-preserving dictionary encoding.

The reference processes full-u64 columns natively (structs.h:11-22,
structs.cpp:28-39); the device path's lanes are 32-bit. These tests drive values up to
2**63 through the device executors (both backends, batched and per-query)
and check exact agreement with the NumPy oracle — including u64 SUM
wraparound and filter constants above the int32 range.
"""

import numpy as np
import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.models.device_catalog import DeviceCatalog
from radixhashjoin_tpu.models.engine import Engine
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)

from test_fuzz import _random_query


def _wide_catalog(rng, n_rel=4, pool_size=60):
    """Relations whose values are huge u64s drawn from a small shared pool
    (so joins actually match), mixed with one narrow relation."""
    pool = rng.integers(0, 2**63, size=pool_size, dtype=np.uint64)
    pool[:4] = [0, 1, 2**32, 2**63 - 1]          # edge values
    rels = []
    for i in range(n_rel):
        n = int(rng.integers(1, 300))
        cols = int(rng.integers(2, 4))
        if i == n_rel - 1:
            data = [rng.integers(0, 100, n).astype(np.uint64)
                    for _ in range(cols)]
        else:
            data = [rng.choice(pool, n) for _ in range(cols)]
        rels.append(Relation(data))
    return rels


def _wide_filter_query(rng, rels, q):
    """Rewrite filter constants to wide-range values (present and absent)."""
    filters = []
    for f in q.filters:
        col = rels[q.slots[f.slot]].values[f.col]
        if rng.random() < 0.5 and len(col):
            k = int(col[rng.integers(0, len(col))])   # a present value
        else:
            k = int(rng.integers(0, 2**63))           # likely absent
        filters.append(FilterPred(f.slot, f.col, f.op, k))
    return Query(q.slots, q.joins, filters, q.projections)


@pytest.mark.parametrize("seed", range(4))
def test_wide_fuzz_dense_matches_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    rels = _wide_catalog(rng)
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig())
    assert engine.batch_executor.catalog.dict_vals is not None
    queries = [_wide_filter_query(rng, rels, _random_query(rng, rels))
               for _ in range(8)]
    got = engine.run_batch(queries)
    expect = [format_result(oracle.execute(q), len(q.projections))
              for q in queries]
    assert got == expect


@pytest.mark.parametrize("seed", range(2))
def test_wide_fuzz_sort_backend_matches_oracle(seed):
    rng = np.random.default_rng(2000 + seed)
    rels = _wide_catalog(rng)
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig(join_backend="sort"))
    queries = [_wide_filter_query(rng, rels, _random_query(rng, rels))
               for _ in range(6)]
    got = engine.run_batch(queries)
    expect = [format_result(oracle.execute(q), len(q.projections))
              for q in queries]
    assert got == expect


def test_wide_per_query_executor():
    rng = np.random.default_rng(7)
    rels = _wide_catalog(rng)
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig(batch_execution=False))
    queries = [_wide_filter_query(rng, rels, _random_query(rng, rels))
               for _ in range(6)]
    got = engine.run_batch(queries)
    expect = [format_result(oracle.execute(q), len(q.projections))
              for q in queries]
    assert got == expect


def test_u64_sum_wraparound():
    # SUMs wrap mod 2**64 exactly like the reference's uint64 accumulator
    big = 2**63 - 7
    r = Relation([np.full(8, big, dtype=np.uint64),
                  np.arange(8, dtype=np.uint64)])
    engine = Engine([r], EngineConfig())
    q = Query([0, 0], [JoinPred(0, 1, 1, 1)], [], [Projection(0, 0)])
    [line] = engine.run_batch([q])
    assert line == str((8 * big) % 2**64)


def test_encode_filter_translation():
    vals = np.array([5, 10, 2**40, 2**63 - 1], dtype=np.uint64)
    cat = DeviceCatalog([Relation([vals])], EngineConfig())
    assert cat.dict_vals is not None
    # '=': present -> its code; absent -> -1
    assert int(cat.encode_filter("=", 2**40)[1]) == 2
    assert int(cat.encode_filter("=", 7)[1]) == -1
    # '<' K: codes strictly below searchsorted_left(K)
    assert int(cat.encode_filter("<", 10)[1]) == 1
    assert int(cat.encode_filter("<", 11)[1]) == 2
    # '>' K: codes strictly above searchsorted_right(K) - 1
    assert int(cat.encode_filter(">", 10)[1]) == 1
    assert int(cat.encode_filter(">", 9)[1]) == 0
    assert int(cat.encode_filter(">", 2**63 - 1)[1]) == 3   # nothing above


def test_narrow_catalog_skips_dictionary(small_catalog):
    cat = DeviceCatalog(small_catalog, EngineConfig())
    assert cat.dict_vals is None


@pytest.mark.parametrize("seed", range(3))
def test_wide_parallel_edges_matches_oracle(seed):
    """Case-3 rewriting over dictionary-encoded u64 values: duplicate
    edges, shared-column parallels (incl. trailing — the support-
    intersection NULL gate compares CODES across two columns, valid only
    because the dictionary is global), and composite fallbacks."""
    from test_case3_rewrite import test_fuzz_parallel_edges  # noqa: F401
    rng = np.random.default_rng(5000 + seed)
    rels = _wide_catalog(rng, n_rel=3, pool_size=12)  # dense pool: matches
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig())
    queries = []
    for _ in range(10):
        nslots = int(rng.integers(2, 4))
        slots = [int(rng.integers(0, len(rels))) for _ in range(nslots)]
        ncols = [rels[s].num_columns for s in slots]
        joins = []
        for _ in range(int(rng.integers(2, 5))):
            if joins and rng.random() < 0.5:
                e = joins[int(rng.integers(0, len(joins)))]
                s1, s2 = e.slot2, e.slot1
                c1 = (e.col2 if rng.random() < 0.6
                      else int(rng.integers(0, ncols[s1])))
                c2 = (e.col1 if rng.random() < 0.6
                      else int(rng.integers(0, ncols[s2])))
                joins.append(JoinPred(s1, c1, s2, c2))
            else:
                s1, s2 = rng.integers(0, nslots, 2)
                joins.append(JoinPred(
                    int(s1), int(rng.integers(0, ncols[s1])),
                    int(s2), int(rng.integers(0, ncols[s2]))))
        projections = [Projection(s, int(rng.integers(0, ncols[s])))
                       for s in range(nslots)]
        queries.append(Query(slots, joins, [], projections))
    got = engine.run_workload([queries])
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want


def test_plane_column_alias_both_orders(monkeypatch):
    """The uint16 projection plane must never stay resident NEXT TO the
    int32 copy of the same huge identity column, whichever of
    proj_planes()/col() runs first (an earlier aliasing fix was
    order-dependent: projection-then-join kept both, 6 B/row)."""
    import numpy as np
    from radixhashjoin_tpu.models import device_catalog as dc
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.storage import Relation
    monkeypatch.setattr(dc, "_NARROW_PLANE_MIN_ROWS", 100)
    rng = np.random.default_rng(0)
    rel = Relation([rng.integers(0, 1000, 500).astype(np.uint64)])

    # order A: join/filter first -> plane aliases the int32 column
    cat = dc.DeviceCatalog([rel], EngineConfig())
    c = cat.col(0, 0)
    planes = cat.proj_planes(0, 0)
    assert planes[0][0] is c

    # order B: projection first (uint16 plane), join later -> the
    # plane re-aliases to the int32 column and the uint16 copy frees
    cat2 = dc.DeviceCatalog([rel], EngineConfig())
    p0 = cat2.proj_planes(0, 0)[0][0]
    assert p0.dtype == np.uint16
    c2 = cat2.col(0, 0)
    assert cat2.proj_planes(0, 0)[0][0] is c2
