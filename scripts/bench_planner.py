"""Join-reordering planner measurement.

The reference computes join-selectivity statistics but never built the
"enumeration" that would consume them (/root/reference/README.md:62-64);
models/planner.py finishes that work behind
EngineConfig.enable_join_reordering. This bench constructs the workload
class where written order is adversarial and measures the flag on/off,
exact against the host oracle both ways:

  R0 (fact A, N rows):  col0 = dup-heavy key (N/D copies each),
                        col1 = wide unique-ish key, col2 = values
  R1 (fact B, N rows):  col0 = the same dup-heavy key domain
  R2 (dim, M rows):     col0 = unique key, col1 = values

  query: 0 1 2 | 0.0=1.0 & 0.1=2.0 & 2.0<K | projections
         (written order joins BIG x BIG first: ~N*(N/D) intermediate
         rows; the selective filtered dim join comes last)

The planner's estimator (models/stats.py, the reference's own formulas)
prices the filtered-dim join cheapest and hoists it, shrinking the
left side before the expansion join ever runs.

NOTE the structural context this measures AGAINST: the factorized path
(ops/factorized.py) never materializes intermediates, so tree queries
are order-INSENSITIVE there — the planner matters on the materialized
path (factorized=False), which is what cyclic/fallback queries use.
Both engines verify exactness; only the materialized one is timed
on/off.

Usage: python scripts/bench_planner.py [--log-rows 18]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--log-rows", type=int, default=18)
    p.add_argument("--log-distinct", type=int, default=14)
    args = p.parse_args()

    import numpy as np

    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.models.planner import reorder_joins
    from radixhashjoin_tpu.oracle import OracleExecutor
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)

    n = 1 << args.log_rows
    d = 1 << args.log_distinct
    m = 1 << 14
    sel_k = 16                       # dim filter keeps rows with col0 < 16
    rng = np.random.default_rng(7)

    r0 = Relation([rng.integers(0, d, n).astype(np.uint64),
                   rng.integers(0, m, n).astype(np.uint64),
                   rng.integers(0, 1000, n).astype(np.uint64)])
    r1 = Relation([rng.integers(0, d, n).astype(np.uint64),
                   rng.integers(0, 1000, n).astype(np.uint64)])
    r2 = Relation([np.arange(m, dtype=np.uint64),
                   rng.integers(0, 1000, m).astype(np.uint64)])
    rels = [r0, r1, r2]

    q = Query([0, 1, 2],
              [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(2, 0, "<", sel_k)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)])

    # what the estimator chose (committed alongside the wall times)
    ordered = reorder_joins(q, rels)
    order_str = [f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}"
                 for j in ordered.joins]

    expect = OracleExecutor(rels).execute(q)

    import jax
    platform = jax.devices()[0].platform

    out = {"metric": "planner_reorder_wall_s", "platform": platform,
           "rows": n, "distinct": d, "dim_rows": m, "sel_k": sel_k,
           "chosen_order": order_str, "unit": "s"}

    for label, flag in (("written", False), ("reordered", True)):
        cfg = EngineConfig(factorized=False, batch_execution=False,
                           enable_join_reordering=flag)
        eng = Engine(rels, cfg)
        got = eng.execute(q)            # warm (compile) + exactness
        assert got == expect, (label, got, expect)
        t0 = time.time()
        got = eng.execute(q)
        wall = time.time() - t0
        assert got == expect
        out[label] = round(wall, 3)

    out["speedup"] = round(out["written"] / max(out["reordered"], 1e-9), 2)
    out["exact_vs_oracle"] = True
    print(json.dumps(out))


if __name__ == "__main__":
    main()
