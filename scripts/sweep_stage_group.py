"""Sweep EngineConfig.stage_group on the current backend.

Grouping g queries into one fused program per round trades dispatch
count against program size and compile count. Runs the seeded contest
workload (radixhashjoin_tpu/datagen.py) and checks every run against
oracle.py. One process, so compiles are paid once per group size.

Usage: python scripts/sweep_stage_group.py [--scale X] [G ...]
Prints one JSON line per configuration, naming the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("groups", nargs="*", type=int, default=[1, 2, 5, 10, 25])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax
    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.datagen import generate
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.oracle import run_workload

    w = generate(args.seed, args.scale)
    relations = w.relations()
    want = run_workload(relations, w.batches)
    dev = jax.devices()[0]
    for g in args.groups:
        engine = Engine(relations, EngineConfig(stage_group=g))
        ok = engine.run_workload(w.batches) == want
        best = None
        for _ in range(3):
            engine.batch_executor.counters = {
                k: 0 for k in engine.batch_executor.counters}
            t0 = time.perf_counter()
            got = engine.run_workload(w.batches)
            wall = time.perf_counter() - t0
            ok = ok and got == want
            if best is None or wall < best:
                best = wall
                counters = dict(engine.batch_executor.counters)
        print(json.dumps({"metric": "stage_group_sweep", "stage_group": g,
                          "platform": dev.platform,
                          "device_kind": dev.device_kind,
                          "wall_s": best, "exact": ok, **counters}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
