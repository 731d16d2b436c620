"""Factorized tree execution (ops/factorized.py) vs the NumPy oracle.

The ftree path replaces the whole join pipeline of tree-shaped queries
with count-message passing; these tests pin its case analysis: chains,
stars, case-1 wipes (wiped components still gate NULL), same-slot
selections (pre-last-join factorized; post-last-join falls back),
overflow-cap fallback, NULL propagation, and wide (u64) values.
"""

import numpy as np
import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.models.batch import BatchExecutor
from radixhashjoin_tpu.oracle import OracleExecutor
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)


def _rels(rng, n_rel=4, vmax=64, nmax=300):
    out = []
    for _ in range(n_rel):
        n = int(rng.integers(2, nmax))
        cols = int(rng.integers(2, 4))
        out.append(Relation([rng.integers(0, vmax, n).astype(np.uint64)
                             for _ in range(cols)]))
    return out


def _tree_query(rng, rels):
    """Random tree-shaped query: every join attaches a fresh slot."""
    nslots = int(rng.integers(2, 5))
    slots = [int(rng.integers(0, len(rels))) for _ in range(nslots)]
    ncols = [rels[s].num_columns for s in slots]
    joined = [0]
    joins = []
    for s in range(1, nslots):
        p = int(rng.choice(joined))
        joins.append(JoinPred(p, int(rng.integers(0, ncols[p])),
                              s, int(rng.integers(0, ncols[s]))))
        joined.append(s)
    filters = []
    for _ in range(int(rng.integers(0, 3))):
        s = int(rng.integers(0, nslots))
        filters.append(FilterPred(s, int(rng.integers(0, ncols[s])),
                                  str(rng.choice(["=", "<", ">"])),
                                  int(rng.integers(0, 70))))
    projections = [Projection(int(rng.integers(0, nslots)), 0)
                   for _ in range(int(rng.integers(1, 4)))]
    return Query(slots, joins, filters, projections)


def _check(rels, queries, **cfg):
    oracle = OracleExecutor(rels)
    ex = BatchExecutor(rels, EngineConfig(**cfg))
    got = ex.run_batch(queries)
    expect = [oracle.execute(q) for q in queries]
    for g, e, q in zip(got, expect, queries):
        assert g == e, (q, g, e)
    return ex


@pytest.mark.parametrize("seed", range(5))
def test_tree_queries_match_oracle(seed):
    rng = np.random.default_rng(200 + seed)
    rels = _rels(rng)
    queries = [_tree_query(rng, rels) for _ in range(8)]
    ex = _check(rels, queries)
    assert ex.counters["ftree_queries"] > 0


@pytest.mark.parametrize("seed", range(3))
def test_factorized_off_agrees(seed):
    """factorized=False must produce identical output (shared oracle)."""
    rng = np.random.default_rng(300 + seed)
    rels = _rels(rng)
    queries = [_tree_query(rng, rels) for _ in range(6)]
    on = BatchExecutor(rels, EngineConfig()).run_batch(queries)
    off = BatchExecutor(rels,
                        EngineConfig(factorized=False)).run_batch(queries)
    assert on == off
    assert BatchExecutor(rels, EngineConfig(
        factorized=False)).counters["ftree_queries"] == 0


@pytest.mark.parametrize("seed", range(2))
def test_wave_off_agrees(seed):
    """ftree_wave=False (per-query message kernels) must match the
    wave-batched path bit for bit at every group size."""
    rng = np.random.default_rng(700 + seed)
    rels = _rels(rng)
    queries = [_tree_query(rng, rels) for _ in range(8)]
    wave = BatchExecutor(rels, EngineConfig(stage_group=8)
                         ).run_batch(queries)
    solo = BatchExecutor(rels, EngineConfig(stage_group=8,
                                            ftree_wave=False)
                         ).run_batch(queries)
    ungrouped = BatchExecutor(rels, EngineConfig(stage_group=1)
                              ).run_batch(queries)
    assert wave == solo == ungrouped


def test_wiped_component_gates_null():
    """First join has zero pairs; a later case-1 join wipes it. The
    reference still prints NULL (Query.cpp:188-191), so the wiped
    component must come back as a flag-only tree."""
    r0 = Relation([np.array([1, 2], np.uint64),
                   np.array([5, 6], np.uint64)])
    r1 = Relation([np.array([3, 4], np.uint64),
                   np.array([7, 8], np.uint64)])
    rels = [r0, r1]
    q_null = Query([0, 1, 0, 1],
                   [JoinPred(0, 0, 1, 0),     # {1,2} vs {3,4}: empty
                    JoinPred(2, 0, 3, 0)],    # wipe; also empty here
                   [], [Projection(2, 0)])
    # same shape but first join non-empty, second empty -> NULL too
    q2 = Query([0, 0, 0, 1],
               [JoinPred(0, 0, 1, 0),         # self pairs: non-empty
                JoinPred(2, 0, 3, 0)],        # wiped comp ok, final empty
               [], [Projection(2, 0)])
    _check(rels, [q_null, q2])


def test_same_slot_selection_positions():
    """Same-slot predicates: before the last join (factorized), as the
    only predicate (single-node tree has no joins -> materialized tail),
    and after the last join (fallback). All must match the oracle."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 8, 50).astype(np.uint64)
    r = Relation([vals, rng.integers(0, 8, 50).astype(np.uint64),
                  rng.integers(0, 99, 50).astype(np.uint64)])
    rels = [r, r]
    qs = [
        Query([0, 1], [JoinPred(0, 0, 0, 1), JoinPred(0, 0, 1, 0)],
              [], [Projection(1, 2), Projection(0, 2)]),
        Query([0], [JoinPred(0, 0, 0, 1)], [], [Projection(0, 2)]),
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 0, 0, 1)],
              [], [Projection(1, 2)]),
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 1, 1)],
              [], [Projection(0, 2)]),
    ]
    _check(rels, qs)


def test_caps_overflow_falls_back():
    """A 3-deep chain of all-equal keys has per-row counts ~n**3; the
    host caps must reject it and the materialized path must answer."""
    n = 2000
    ones = np.ones(n, np.uint64)
    r = Relation([ones, np.arange(n, dtype=np.uint64) % 97])
    rels = [r, r, r, r]
    # caps see load-time max_mult = 2000 per level (2000**3 >= 2**31);
    # the filters keep the ACTUAL output small (~21**4 rows) so the
    # materialized fallback can answer and the oracle can verify
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 2, 0),
               JoinPred(2, 0, 3, 0)],
              [FilterPred(s, 1, "<", 1) for s in range(4)],
              [Projection(0, 1)])
    ex = _check(rels, [q])
    assert ex.counters["ftree_queries"] == 0


def test_star_and_deep_chain():
    """Star (root with 3 children) exercises the exclusion products;
    4-chain exercises multi-level alpha composition."""
    rng = np.random.default_rng(11)
    rels = _rels(rng, n_rel=5, vmax=16)
    star = Query([0, 1, 2, 3],
                 [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0),
                  JoinPred(0, 0, 3, 1)],
                 [FilterPred(1, 0, "<", 9)],
                 [Projection(s, 1) for s in range(4)])
    chain = Query([0, 1, 2, 3],
                  [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                   JoinPred(2, 1, 3, 0)],
                  [FilterPred(3, 0, ">", 3)],
                  [Projection(0, 1), Projection(3, 1)])
    ex = _check(rels, [star, chain])
    assert ex.counters["ftree_queries"] == 2


def test_wide_values_factorized():
    """u64 columns ride the dictionary codes + 16-bit planes through the
    factorized weighted sums."""
    rng = np.random.default_rng(13)
    big = (rng.integers(0, 50, 200).astype(np.uint64) << np.uint64(40))
    r0 = Relation([big, rng.integers(0, 9, 200).astype(np.uint64)])
    r1 = Relation([big[rng.permutation(200)],
                   (rng.integers(0, 50, 200).astype(np.uint64)
                    << np.uint64(35))])
    rels = [r0, r1]
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)],
              [FilterPred(0, 1, "<", 5)],
              [Projection(0, 0), Projection(1, 1)])
    ex = _check(rels, [q])
    assert ex.counters["ftree_queries"] == 1


def test_lazy_gather_path_matches_oracle(monkeypatch):
    """The HBM-bounded big-wave path (lazy beta gathers folded window by
    window + the width-sized support-table root flag) must be exact;
    forced at test size by shrinking the thresholds. Covers sums,
    zeros, and NULL outcomes."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.utils import limbs
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(21)
    n = 6 * 4096 + 123                   # ragged, several windows
    fact = Relation([rng.integers(0, 500, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    dim = Relation([np.arange(500, dtype=np.uint64),
                    rng.integers(0, 1000, 500).astype(np.uint64)])
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)]),
        # filter matches nothing -> NULL through the support-table flag
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "=", 12345)],
              [Projection(0, 1)]),
        # filter on the FACT node: the lazy projection fold carries a
        # msg_mask and must fold it window by window (not materialize)
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 700)],
              [Projection(0, 1), Projection(1, 1)]),
    ]
    oracle = OracleExecutor([fact, dim])
    engine = Engine([fact, dim], EngineConfig())
    got = engine.run_workload([queries])
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want, (got, want)
    assert engine.batch_executor.counters["ftree_queries"] == 3


def test_lazy_star_multi_edge_matches_oracle(monkeypatch):
    """Multi-edge (star) trees through the HBM-bounded huge path: the
    fact node's beta is a lazy PRODUCT of message gathers (never
    materialized), dim projections ride windowed down-pass scatters
    whose weights are lazy sibling products, and NULL comes from the
    windowed-OR flag over the product. Forced at test size by
    shrinking the thresholds; covers sums, fact filters (mask factor),
    dim projections (down pass), NULL, and a huge wiped boolean
    component."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(33)
    n = 5 * 4096 + 77                    # ragged, several windows
    fact = Relation([rng.integers(0, 300, n).astype(np.uint64),
                     rng.integers(0, 200, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    d1 = Relation([np.arange(300, dtype=np.uint64),
                   rng.integers(0, 1000, 300).astype(np.uint64)])
    d2 = Relation([np.arange(200, dtype=np.uint64),
                   rng.integers(0, 1000, 200).astype(np.uint64)])
    rels = [fact, d1, d2]
    star = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
    queries = [
        # 2-edge star, sums on fact AND both dims (down pass over the
        # huge fact with a lazy sibling-product weight)
        Query([0, 1, 2], star, [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        # fact-side filter -> mask factor in every lazy consumer
        Query([0, 1, 2], star, [FilterPred(0, 2, "<", 700)],
              [Projection(0, 2), Projection(2, 1)]),
        # both dims filtered to nothing -> NULL via the windowed-OR
        # flag over the lazy product
        Query([0, 1, 2], star, [FilterPred(1, 1, "=", 55555)],
              [Projection(0, 2)]),
        # huge wiped component (boolean lazy tree): the first join pairs
        # fact with d1, then a case-1 join of fresh d2 x d2 wipes it;
        # the wiped HUGE component still gates NULL through the boolean
        # (clamped) lazy path
        Query([0, 1, 2, 2], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 1)]),
    ]
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig())
    got = engine.run_workload([queries])
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want, (got, want)


def test_narrow_uint16_planes_fold_exact(monkeypatch):
    """Huge single-chip columns store 16-bit-fitting projection planes
    as uint16 (models/device_catalog.py:_NARROW_PLANE_MIN_ROWS): half
    the HBM at 2**30 rows, and every exact fold path must zero-extend
    them unchanged (utils/limbs.py:_channel_sums enters via
    astype(uint32)). Forced at test size; covers the identity catalog,
    the dictionary catalog's single- and multi-plane (u64) branches,
    and a >=2**16 identity column that must STAY int32."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models import device_catalog
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.utils import limbs
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    monkeypatch.setattr(device_catalog, "_NARROW_PLANE_MIN_ROWS", 1024)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(7)
    n = 3 * 4096 + 55
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)])

    def run(fact_vals):
        fact = Relation([rng.integers(0, 400, n).astype(np.uint64),
                         fact_vals])
        dim = Relation([np.arange(400, dtype=np.uint64),
                        rng.integers(0, 1000, 400).astype(np.uint64)])
        engine = Engine([fact, dim], EngineConfig())
        got = engine.run_workload([[q]])
        want = [format_result(OracleExecutor([fact, dim]).execute(q), 2)]
        assert got == want, (got, want)
        assert engine.batch_executor.counters["ftree_queries"] == 1
        return engine.batch_executor.catalog.proj_planes(0, 1)

    # identity catalog, values < 2**16 -> one uint16 plane
    planes = run(rng.integers(0, 1000, n).astype(np.uint64))
    assert [(p.dtype, s) for p, s in planes] == [(np.dtype(np.uint16), 0)]

    # identity catalog, values >= 2**16 -> stays int32 (shared col)
    planes = run(rng.integers(0, 1 << 20, n).astype(np.uint64))
    assert [(p.dtype, s) for p, s in planes] == [(np.dtype(np.int32), 0)]

    # dictionary catalog (u64 values force it), narrow projected column
    # -> one uint16 plane
    wide = rng.integers(0, 1000, n).astype(np.uint64) + (1 << 40)
    fact = Relation([rng.integers(0, 400, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    dim = Relation([np.arange(400, dtype=np.uint64), wide[:400]])
    qs = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 900)],
                [Projection(0, 1), Projection(1, 1)])]
    engine = Engine([fact, dim], EngineConfig())
    got = engine.run_workload([qs])
    want = [format_result(OracleExecutor([fact, dim]).execute(qs[0]), 2)]
    assert got == want, (got, want)
    cat = engine.batch_executor.catalog
    assert [p.dtype for p, _s in cat.proj_planes(0, 1)] == [np.uint16]
    # the u64 dim column is small (400 rows) -> multi-plane int32
    assert all(p.dtype == np.int32 for p, _s in cat.proj_planes(1, 1))

    # dictionary catalog, HUGE u64 projected column -> uint16 planes
    fact2 = Relation([rng.integers(0, 400, n).astype(np.uint64), wide])
    engine = Engine([fact2, dim], EngineConfig())
    got = engine.run_workload([[q]])
    want = [format_result(OracleExecutor([fact2, dim]).execute(q), 2)]
    assert got == want, (got, want)
    cat = engine.batch_executor.catalog
    pl = cat.proj_planes(0, 1)
    assert len(pl) > 1 and all(p.dtype == np.uint16 for p, _s in pl)


def test_huge_star_window_scatter_matches_oracle(monkeypatch):
    """The huge-node window loops route their per-window table builds
    through scatter_add_window; a star over a ragged huge fact must stay
    exact through the full engine."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.utils import limbs
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(5)
    n = 4 * 4096 + 33
    fact = Relation([rng.integers(0, 300, n).astype(np.uint64),
                     rng.integers(0, 200, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    d1 = Relation([np.arange(300, dtype=np.uint64),
                   rng.integers(0, 1000, 300).astype(np.uint64)])
    d2 = Relation([np.arange(200, dtype=np.uint64),
                   rng.integers(0, 1000, 200).astype(np.uint64)])
    rels = [fact, d1, d2]
    q = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)])
    engine = Engine(rels, EngineConfig())
    got = engine.run_workload([[q]])
    want = [format_result(OracleExecutor(rels).execute(q), 3)]
    assert got == want, (got, want)
    assert engine.batch_executor.counters["ftree_queries"] == 1


def test_huge_fused_pass_matches_oracle(monkeypatch):
    """Fused window passes over a huge node at shrunken thresholds:
    single join, 2-edge stars (shared per-window gathers), fact masks,
    dim projections (down-pass A builds), ragged-tail live masks, NULL
    flags, and a huge wiped boolean component."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(97)
    n = 5 * 4096 + 77                    # ragged, several windows
    fact = Relation([rng.integers(0, 300, n).astype(np.uint64),
                     rng.integers(0, 200, n).astype(np.uint64),
                     rng.integers(0, 1000, n).astype(np.uint64)])
    d1 = Relation([np.arange(300, dtype=np.uint64),
                   rng.integers(0, 1000, 300).astype(np.uint64)])
    d2 = Relation([np.arange(200, dtype=np.uint64),
                   rng.integers(0, 1000, 200).astype(np.uint64)])
    rels = [fact, d1, d2]
    star = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
    queries = [
        # single join
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 2), Projection(1, 1)]),
        # star with dim + fact projections (down-pass A builds + folds
        # + flag share one window loop)
        Query([0, 1, 2], star, [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        # fact filter -> mask factor of every window
        Query([0, 1, 2], star, [FilterPred(0, 2, "<", 700)],
              [Projection(0, 2), Projection(2, 1)]),
        # NULL via the windowed-OR flag
        Query([0, 1, 2], star, [FilterPred(1, 1, "=", 55555)],
              [Projection(0, 2)]),
        # huge wiped boolean component (clamped lazy gathers)
        Query([0, 1, 2, 2], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 1)]),
    ]
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig())
    got = engine.run_workload([queries])
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want, (got, want)


def test_huge_chain_two_deep_matches_oracle(monkeypatch):
    """A CHAIN of two huge nodes (fact1 JOIN fact2 JOIN dim): both
    middle levels run the HBM-bounded machinery — the up-pass B build
    over huge fact2 with a lazy gather weight, the down-pass A builds
    over both huge nodes, and folds on both — at shrunken thresholds."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(123)
    n1, n2 = 3 * 4096 + 11, 4 * 4096 + 55      # both > _BIG_WAVE_ROWS
    f1 = Relation([rng.integers(0, 200, n1).astype(np.uint64),
                   rng.integers(0, 1000, n1).astype(np.uint64)])
    f2 = Relation([rng.integers(0, 200, n2).astype(np.uint64),
                   rng.integers(0, 150, n2).astype(np.uint64),
                   rng.integers(0, 1000, n2).astype(np.uint64)])
    dim = Relation([np.arange(150, dtype=np.uint64),
                    rng.integers(0, 1000, 150).astype(np.uint64)])
    rels = [f1, f2, dim]
    chain = [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0)]
    queries = [
        Query([0, 1, 2], chain, [FilterPred(2, 1, "<", 800)],
              [Projection(0, 1), Projection(1, 2), Projection(2, 1)]),
        # filter on the middle huge node -> mask factors both loops
        Query([0, 1, 2], chain, [FilterPred(1, 2, "<", 600)],
              [Projection(0, 1), Projection(2, 1)]),
        # NULL through the chain
        Query([0, 1, 2], chain, [FilterPred(2, 1, "=", 99999)],
              [Projection(0, 1)]),
    ]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    engine = Engine(rels, EngineConfig())
    got = engine.run_workload([queries])
    assert got == want, (got, want)


def test_huge_wide_key_matches_oracle(monkeypatch):
    """A huge node joined on a 16-bit key domain (60000-wide message
    tables) with a projected column past 2**15."""
    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(41)
    n = 3 * 4096 + 7
    nk = 60000                         # 16-bit key domain and plane
    fact = Relation([rng.integers(0, nk, n).astype(np.uint64),
                     rng.integers(0, nk, n).astype(np.uint64)])
    dim = Relation([np.arange(nk, dtype=np.uint64),
                    rng.integers(0, 1000, nk).astype(np.uint64)])
    rels = [fact, dim]
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 1), Projection(1, 1)]),
    ]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    engine = Engine(rels, EngineConfig())
    got = engine.run_workload([queries])
    assert got == want, (got, want)
    assert engine.batch_executor.counters["ftree_queries"] == 1
