"""Case-3 (cycle) rewriting in the factorized planner.

The reference executes a join between two already-joined slots as a row
filter with a pair-set-empty NULL test (update_intermediate case 3,
/root/reference/intermediate.cpp:72-87,130-138; Query.cpp:188-191). The
planner (models/batch.py:_extract_tree) rewrites such edges via
union-find over (slot, col) value-equivalence classes:

  * duplicate edge            -> identity, dropped
  * shared-column parallel    -> same-slot selection (join-born)
  * parallel edge, 4 columns  -> FUSE into the existing edge as a
                                 composite key (shared pair dictionary,
                                 DeviceCatalog.edge_key); a TRAILING one
                                 additionally plans a boolean companion
                                 spec of the pre-fusion tree whose
                                 cross-node support-intersection gate
                                 carries the step-pair-set NULL rule
  * transitive composite cycle-> fall back to the materializing path

and ops/factorized.py gates NULL for a TRAILING selection from the
pre-selection rows (support-intersection test for join-born ones). Every
test here cross-checks the engine against the NumPy oracle and asserts
which path ran via the ftree_queries counter.
"""

import numpy as np
import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.models.engine import Engine
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)


def _u64(*cols):
    return Relation([np.array(c, np.uint64) for c in cols])


def _run(rels, q, expect_ftree):
    engine = Engine(rels, EngineConfig())
    got = engine.run_workload([[q]])
    used = engine.batch_executor.counters["ftree_queries"]
    assert used == (1 if expect_ftree else 0), (
        f"expected ftree={expect_ftree}, counter={used}")
    oracle = format_result(OracleExecutor(rels).execute(q),
                           len(q.projections))
    assert got == [oracle], f"engine {got!r} != oracle {oracle!r}"
    return got[0]


def test_trailing_join_born_pair_set_empty_is_null():
    # join 0.0=1.0, then 1.0=0.1 (case 3) -> sel col1==col0 on slot 0.
    # A.col1 shares no value with the joined keys -> pair set empty -> NULL
    A = _u64([1, 2], [5, 6])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "NULL NULL"


def test_trailing_join_born_pairs_nonempty_zero_rows_is_zeros():
    # values cross rows: pair set {1,2} nonempty, but no row has
    # col1==col0 -> the reference prints 0 sums, NOT NULL
    A = _u64([1, 2], [2, 1])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "0 0"


def test_trailing_join_born_surviving_rows():
    # row 1 survives (col1==col0==2); sums reflect only that row
    A = _u64([1, 2], [9, 2])
    B = _u64([1, 2, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1)],
              [], [Projection(0, 1), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "4 4"       # rows (A1,B1),(A1,B2) survive: 2+2 each


def test_trailing_native_sel_empties_to_zeros():
    # a same-slot predicate after the last join empties every row but
    # never NULLs (Query.cpp:168-170) — previously a fallback, now ftree
    A = _u64([1, 2], [3, 4])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "0 0"


def test_trailing_native_sel_keeps_rows():
    A = _u64([1, 2], [1, 4])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "1 1"


def test_duplicate_edge_dropped_as_identity():
    # golden q19/q34/q37 shape: the repeated edge is an identity filter
    A = _u64([1, 2, 3])
    B = _u64([1, 2, 2])
    C = _u64([2, 3])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 2, 0),
               JoinPred(1, 0, 0, 0)],
              [], [Projection(0, 0), Projection(2, 0)])
    out = _run([A, B, C], q, expect_ftree=True)
    assert out == "4 4"       # key 2 matches twice in B, once in C


def test_mid_sequence_join_born_sel():
    # golden q48 shape: case-3 rewrite happens BEFORE a later tree edge
    A = _u64([1, 2], [1, 9])
    B = _u64([1, 2])
    C = _u64([1, 1])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1),
               JoinPred(1, 0, 2, 0)],
              [], [Projection(0, 0), Projection(2, 0)])
    out = _run([A, B, C], q, expect_ftree=True)
    assert out == "2 2"       # only row0 (col0==col1==1), C matches twice


def test_trailing_composite_cycle_factorizes_exact():
    # a parallel edge over 4 distinct columns arriving as the LAST join:
    # the fused tree carries the sums (root flag suppressed) and a
    # boolean companion spec of the PRE-fusion tree decides NULL via the
    # cross-node support-intersection gate (the step-pair-set rule,
    # Query.cpp:188-191)
    A = _u64([1, 2, 3], [4, 5, 6])
    B = _u64([1, 2, 9], [4, 5, 7])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 0), Projection(1, 1)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "3 9"


def test_trailing_composite_pair_set_nonempty_zeros_not_null():
    # the fused multiset is EMPTY (no aligned row satisfies both
    # equalities) but the pair set of the trailing step is NOT (value 20
    # appears in both col1 sets over the pre-fusion joined rows):
    # sums are 0, NOT NULL — the case the old planner fell back on
    A = _u64([1, 2], [10, 20], [5, 6])
    B = _u64([1, 2], [20, 10], [100, 200])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 2), Projection(1, 2)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "0 0"


def test_trailing_composite_pair_set_empty_is_null():
    # the trailing pair columns share no value over the pre-fusion
    # joined rows -> the step's pair set is empty -> NULL
    A = _u64([1, 2], [10, 20], [5, 6])
    B = _u64([1, 2], [77, 88], [100, 200])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 2), Projection(1, 2)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "NULL NULL"


def test_trailing_fusion_with_trailing_selection_falls_back():
    # a trailing fusion coexisting with a same-position selection loses
    # the relative predicate order (which decides the gate's pre-state):
    # the planner must take the materializing path and still match
    A = _u64([1, 2, 3], [4, 5, 6], [4, 5, 7])
    B = _u64([1, 2, 9], [4, 5, 7])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
               JoinPred(0, 1, 0, 2)],
              [], [Projection(0, 0), Projection(1, 1)])
    _run([A, B], q, expect_ftree=False)


def test_composite_cycle_fuses_when_not_trailing():
    # the same parallel edge followed by another join FUSES into a
    # composite key (DeviceCatalog.edge_key pair dictionary) and the
    # whole query stays factorized
    A = _u64([1, 2, 3, 2], [4, 5, 6, 5])
    B = _u64([1, 2, 9, 2], [4, 5, 7, 8])
    C = _u64([10, 20, 30, 20])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
               JoinPred(1, 0, 2, 0)],
              [], [Projection(0, 0), Projection(1, 1), Projection(2, 0)])
    _run([A, B, C], q, expect_ftree=True)


def test_composite_fused_edge_empties_to_null():
    # the fused edge's pair set is empty (no row satisfies BOTH
    # equalities) while each single predicate alone would match: the
    # later join sees empty input -> NULL, exactly like the oracle
    A = _u64([1, 2], [5, 6])
    B = _u64([1, 2], [6, 5])          # col0 matches, col1 never pairs
    C = _u64([1, 2])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
               JoinPred(1, 0, 2, 0)],
              [], [Projection(2, 0)])
    out = _run([A, B, C], q, expect_ftree=True)
    assert out == "NULL"


def test_triple_composite_key_fuses():
    # three parallel edges -> a 3-column composite key (recursive fold)
    A = _u64([1, 1, 2], [3, 4, 4], [7, 8, 8], [100, 200, 300])
    B = _u64([1, 1, 2], [4, 3, 4], [8, 9, 8], [10, 20, 30])
    C = _u64([10, 20, 30])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
               JoinPred(0, 2, 1, 2), JoinPred(1, 3, 2, 0)],
              [], [Projection(0, 3), Projection(2, 0)])
    _run([A, B, C], q, expect_ftree=True)


def test_transitive_composite_cycle_falls_back():
    # an IRREDUCIBLE cycle: it closes over columns fresh to the
    # equivalence classes between slots connected only THROUGH a third
    # node — no pairing of class members lands on one slot or a direct
    # edge -> materializing path
    A = _u64([1, 2], [5, 6])
    B = _u64([1, 2], [7, 8])
    C = _u64([7, 8], [5, 6])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
               JoinPred(2, 1, 0, 1)],
              [], [Projection(0, 0)])
    _run([A, B, C], q, expect_ftree=False)


def test_transitive_cycle_rewrites_onto_direct_edge():
    # chain A-B-C, then A.0 = C.1: class(A.0) contains (B,0) via the
    # first edge, and B-C IS a direct edge -> the predicate fuses into
    # it as a composite key (path rewrite through the union-find) — the
    # class the old planner fell back on
    A = _u64([1, 2, 3], [10, 20, 30])
    B = _u64([1, 2, 2], [7, 8, 9])
    C = _u64([7, 8, 9, 8], [1, 2, 3, 9])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
               JoinPred(0, 0, 2, 1)],
              [], [Projection(0, 1), Projection(2, 0)])
    _run([A, B, C], q, expect_ftree=True)


def test_transitive_cycle_rewrites_to_same_slot_sel():
    # two classes meet on a MIDDLE slot: A.0 ~ B.0 and C.0 ~ B.1, so
    # A.0 = C.0 collapses to the same-slot selection B.0 == B.1
    A = _u64([1, 2, 3], [10, 20, 30])
    B = _u64([1, 2, 3], [1, 5, 3])
    C = _u64([1, 3, 5], [100, 200, 300])
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 1, 1),
               JoinPred(0, 0, 2, 0)],
              [], [Projection(0, 1), Projection(2, 1)])
    _run([A, B, C], q, expect_ftree=True)


def test_transitive_cycle_trailing_pair_gate():
    # the rewritten-onto-a-direct-edge predicate arrives TRAILING: the
    # fused tree carries the sums and the boolean companion's cross-node
    # gate carries the step pair-set NULL rule over the REWRITTEN pair
    # (exact: class equality holds on every pre-trailing row)
    A = _u64([1, 2], [10, 20])
    B = _u64([1, 2], [7, 8])
    C = _u64([7, 8], [5, 6])      # C.1 never equals A.0 ~ B.0
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
               JoinPred(0, 0, 2, 1)],
              [], [Projection(0, 1)])
    out = _run([A, B, C], q, expect_ftree=True)
    assert out == "NULL"          # pair set empty -> NULL


def test_multiple_trailing_native_sels_surviving_rows():
    # TWO same-slot selections after the last join, on DIFFERENT nodes:
    # the sums spec masks both (tsels) and the trailing-free companion
    # decides NULL — previously a fallback
    A = _u64([1, 2, 3], [1, 5, 3], [1, 9, 3])
    B = _u64([1, 2, 3], [4, 5, 6], [4, 9, 6])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 0, 2),
               JoinPred(1, 1, 1, 2)],
              [], [Projection(0, 0), Projection(1, 1)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "4 10"          # rows 0 and 2 survive both selections


def test_multiple_trailing_native_sels_empty_is_zeros_not_null():
    # the trailing selections empty every row, but the JOIN was
    # non-empty: sums 0, NOT NULL (Query.cpp:168-170 — natives never
    # NULL; the companion's pre-trailing root flag stays quiet)
    A = _u64([1, 2], [9, 9], [1, 2])
    B = _u64([1, 2], [7, 7], [1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 0, 2),
               JoinPred(1, 1, 1, 2)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "0 0"


def test_multiple_trailing_sels_join_empty_is_null():
    # the join itself empties -> NULL regardless of the trailing sels
    A = _u64([1, 2], [1, 2], [1, 2])
    B = _u64([8, 9], [8, 9], [8, 9])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 0, 2),
               JoinPred(1, 1, 1, 2)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "NULL NULL"


def test_born_first_then_native_trailing():
    # a join-born trailing selection FOLLOWED by a native one: the born
    # gate (pair-set rule) evaluates on the pre-trailing state — its
    # position first makes that exact; pair set nonempty + the native
    # empties the rows -> 0s, not NULL
    A = _u64([1, 2], [2, 1], [5, 6], [7, 8])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1),
               JoinPred(0, 2, 0, 3)],
              [], [Projection(0, 0), Projection(1, 0)])
    out = _run([A, B], q, expect_ftree=True)
    assert out == "0 0"


def test_native_then_born_trailing_falls_back():
    # a born entry NOT first among the trailing selections: its pair
    # set evaluates after the native's re-masking, which the flag
    # machinery doesn't model -> materializing path, still exact
    A = _u64([1, 2], [2, 1], [5, 6], [5, 6])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 2, 0, 3),
               JoinPred(1, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 0)])
    _run([A, B], q, expect_ftree=False)


def test_wiped_comp_trailing_born_gate():
    # a trailing join-born selection inside a comp later WIPED by a
    # case-1 join: its pair-set NULL test must still gate the query
    # (flag-only born gate) — previously a fallback
    A = _u64([1, 2], [5, 6])      # A.1 shares no value with the keys
    B = _u64([1, 2])
    C = _u64([3, 4])
    D = _u64([3, 4, 4])
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1),
               JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 0), Projection(3, 0)])
    out = _run([A, B, C, D], q, expect_ftree=True)
    assert out == "NULL NULL"     # wiped comp's pair set was empty


def test_wiped_comp_trailing_born_gate_nonempty():
    # same shape, pair set NONEMPTY in the wiped comp: the later comp's
    # rows carry the sums
    A = _u64([1, 2], [2, 9])      # value 2 pairs across the columns
    B = _u64([1, 2])
    C = _u64([3, 4])
    D = _u64([3, 4, 4])
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1),
               JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 0), Projection(3, 0)])
    out = _run([A, B, C, D], q, expect_ftree=True)
    assert out == "11 11"         # (3,3),(4,4),(4,4)


def test_identity_after_pending_trailing_sel_falls_back():
    # a selection pending at the drop position could empty the rows and
    # flip the dropped edge's NULL test — the planner must fall back
    A = _u64([1, 2], [3, 4])
    B = _u64([1, 2])
    q = Query([0, 1],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 0, 0, 1),
               JoinPred(1, 0, 0, 0)],
              [], [Projection(0, 0)])
    _run([A, B], q, expect_ftree=False)


def test_golden_cyclic_queries_factorize(small_catalog, small_batches,
                                         golden_lines):
    """The contest queries with parallel edges all ride the ftree path."""
    queries = [q for b in small_batches for q in b]
    idx = [i for i, q in enumerate(queries)
           if len({frozenset((j.slot1, j.slot2)) for j in q.joins})
           < len(q.joins)]
    assert len(idx) >= 2
    engine = Engine(small_catalog, EngineConfig())
    got = engine.run_workload([[queries[i] for i in idx]])
    assert got == [golden_lines[i] for i in idx]
    assert engine.batch_executor.counters["ftree_queries"] == len(idx)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_parallel_edges(seed):
    """Random queries with deliberately repeated/parallel edges: every
    rewrite decision (drop / sel / fallback) must match the oracle."""
    rng = np.random.default_rng(1000 + seed)
    rels = []
    for _ in range(3):
        n = int(rng.integers(1, 120))
        cols = int(rng.integers(2, 4))
        rels.append(Relation([rng.integers(0, 9, n).astype(np.uint64)
                              for _ in range(cols)]))
    oracle = OracleExecutor(rels)
    engine = Engine(rels, EngineConfig())
    queries = []
    for _ in range(12):
        nslots = int(rng.integers(2, 4))
        slots = [int(rng.integers(0, len(rels))) for _ in range(nslots)]
        ncols = [rels[s].num_columns for s in slots]
        joins = []
        for _ in range(int(rng.integers(2, 6))):
            if joins and rng.random() < 0.5:
                # parallel edge: reuse a previous edge's slots, maybe
                # its columns (duplicate / shared-column / composite)
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
