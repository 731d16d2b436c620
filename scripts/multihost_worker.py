"""Multi-host worker: one engine process of an N-process run.

Usage: python scripts/multihost_worker.py <process_id> <num_processes>
       <coordinator host:port>

Each process contributes its local devices to the global mesh and runs
the SAME distributed workload (multi-host SPMD: identical host programs,
sharded device data — parallel/multihost.py). The coordinator process
prints per-query results and MULTIHOST_OK on an oracle match. On CPU this
runs 4 virtual devices per process (tests/test_multihost.py spawns 2
processes for a 2x4 global mesh); on a GPU cluster the same script runs
one process per host with its real cards.
"""

import os
import sys

if __name__ == "__main__":
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()

    import jax
    try:
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    except (RuntimeError, KeyError):
        pass

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from radixhashjoin_tpu.parallel.multihost import (global_mesh,
                                                      init_multihost,
                                                      is_coordinator)
    init_multihost(coord, nproc, pid)

    import numpy as np
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    from radixhashjoin_tpu.parallel import DistExecutor
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)

    # identical data on every process (fixed seed): device_put with the
    # replicated sharding gives one consistent global array
    rng = np.random.default_rng(7)
    rels = [Relation([rng.integers(0, 64, 2000).astype(np.uint64)
                      for _ in range(3)]),
            Relation([rng.integers(0, 64, 700).astype(np.uint64)
                      for _ in range(2)])]
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 40)],
              [Projection(0, 2), Projection(1, 1)]),
        Query([0, 1, 0], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 1)],
              [], [Projection(2, 0)]),
        Query([0, 1], [JoinPred(0, 0, 1, 1)], [FilterPred(1, 0, "=", 9999)],
              [Projection(0, 0)]),
    ]

    mesh = global_mesh()
    ex = DistExecutor(rels, EngineConfig(), mesh=mesh)
    oracle = OracleExecutor(rels)
    ok = True
    for q in queries:
        got = format_result(ex.execute(q), len(q.projections))
        exp = format_result(oracle.execute(q), len(q.projections))
        if is_coordinator():
            print(f"{got}  (expect {exp})", flush=True)
        ok &= got == exp
    if is_coordinator():
        print("MULTIHOST_OK" if ok else "MULTIHOST_MISMATCH", flush=True)
    sys.exit(0 if ok else 1)
