"""Direct unit tests for the deferred-attach planner and speculative
expansion sizing (models/batch.py _plan_stage) — the subtlest logic in the
engine, previously covered only indirectly.

Every scenario checks exact agreement with the NumPy oracle AND asserts
the planner actually took the intended shape (dispatch counts, retry
counts), so a mis-deferral localizes here instead of showing up as a
wrong sum in a fuzz seed.
"""

import numpy as np
import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.models.batch import BatchExecutor
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)


def _rels(seed=0, n=400, vmax=32):
    rng = np.random.default_rng(seed)
    return [Relation([rng.integers(0, vmax, n).astype(np.uint64)
                      for _ in range(3)]) for _ in range(4)]


def _run(rels, q, config=None):
    ex = BatchExecutor(rels, config or EngineConfig())
    [got] = ex.run_batch([q])
    exp = OracleExecutor(rels).execute(q)
    n = len(q.projections)
    assert format_result(got, n) == format_result(exp, n)
    return ex


def test_single_deferred_middle_attach():
    # 0-1 join, then 1-2 middle attach (slot 2 never referenced again),
    # then 1-3 terminal: the middle join must fold into one dispatch chain
    rels = _rels(1)
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
               JoinPred(1, 2, 3, 0)],
              [FilterPred(0, 1, "<", 20)],
              [Projection(0, 2), Projection(2, 1), Projection(3, 1)])
    _run(rels, q)


def test_two_deferred_slots_with_projections_on_both():
    # joins: 0-1 (materializing), 1-2 deferred, 0-3 deferred is the
    # TERMINAL... make both middles deferred: 0-1, then 1-2 (slot 2 never
    # again), then 0-3 (slot 3 never again) as terminal -> only ONE
    # deferral; to get two, use 4 joins
    rels = _rels(2)
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0),      # materializing pair
               JoinPred(1, 1, 2, 0),      # deferred (2 unused later)
               JoinPred(0, 1, 3, 0)],     # deferred or terminal
              [],
              [Projection(2, 1), Projection(3, 1), Projection(0, 2)])
    ex = _run(rels, q)
    # whole query must be a single dispatch (no expansion readbacks)
    assert ex.counters["dispatches"] == 1
    assert ex.counters["spec_retries"] == 0


def test_deferral_at_depth_then_materializing_join():
    # the deferred join is NOT adjacent to the terminal: 1-2 deferred at
    # k=1, then 1-3 materializes (slot 3 IS referenced by the terminal
    # via... make k=2 terminal reference slot 1 again) — deferral at any
    # depth with later expansions must carry mult rows through
    rels = _rels(3)
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0),      # pair
               JoinPred(1, 1, 2, 0),      # deferred at depth (2 unused)
               JoinPred(0, 1, 3, 0),      # terminal
               ],
              [FilterPred(2, 1, ">", 4)],
              [Projection(0, 1), Projection(2, 2), Projection(3, 1)])
    _run(rels, q)


def test_deferral_then_case3_row_filter_end():
    # pipeline ENDS on a case-3 row filter after a deferral: trailing
    # projections must be mult-weighted (project_w / project_defer_nt)
    rels = _rels(4)
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0),      # pair
               JoinPred(1, 1, 2, 0),      # deferred (2 unused later)
               JoinPred(0, 1, 1, 2)],     # case 3: both joined, row filter
              [],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)])
    _run(rels, q)


def test_deferral_cleared_by_case1_wipe():
    # a later fresh-fresh join wipes the component INCLUDING its deferred
    # attach (SURVEY.md §8.5); sums must come only from the new component
    rels = _rels(5)
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0),      # pair (component A)
               JoinPred(1, 1, 2, 0),      # deferred onto A
               JoinPred(3, 0, 3, 1)],     # same-slot fresh: wipes A
              [],
              [Projection(3, 2), Projection(0, 1), Projection(2, 1)])
    _run(rels, q)


@pytest.mark.slow
def test_speculation_retry_on_undersized_estimate():
    # force mis-speculation: slack ~0 under-sizes every expansion; the
    # device flag must trigger an exact-path retry with identical results
    rels = _rels(6, n=600, vmax=4)    # heavy duplication -> big expansions
    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
               JoinPred(2, 1, 0, 1)],
              [], [Projection(0, 2), Projection(2, 2)])
    cfg = EngineConfig(speculate_slack=1e-6)
    ex = _run(rels, q, cfg)
    assert ex.counters["spec_retries"] == 1


def test_speculation_off_matches_default():
    rels = _rels(7)
    queries = [Query([0, 1, 2],
                     [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                      JoinPred(2, 1, 0, 1)],
                     [FilterPred(1, 0, "<", 25)],
                     [Projection(0, 1), Projection(2, 0)])]
    on = BatchExecutor(rels, EngineConfig()).run_batch(queries)
    off = BatchExecutor(
        rels, EngineConfig(speculate_expansions=False)).run_batch(queries)
    assert on == off
    exp = OracleExecutor(rels).execute(queries[0])
    assert on[0] == exp


def test_defer_middle_off_matches_default():
    rels = _rels(8)
    q = Query([0, 1, 2, 3],
              [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
               JoinPred(1, 2, 3, 0)],
              [], [Projection(2, 1), Projection(3, 1)])
    on = BatchExecutor(rels, EngineConfig()).run_batch([q])
    off = BatchExecutor(rels, EngineConfig(defer_middle=False)).run_batch([q])
    assert on == off
