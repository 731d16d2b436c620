"""CLI entry: `python -m radixhashjoin_tpu < init+work` — the reference's
`cat small/small.init small/small.work | ./join` contract (Makefile:13-14),
plus a real flag surface (the reference's entire tuning surface was three
compile-time macros, SURVEY.md §5).
"""

from __future__ import annotations

import argparse
import sys

from .config import EngineConfig
from .models.engine import main


def cli() -> None:
    p = argparse.ArgumentParser(
        prog="radixhashjoin_tpu",
        description="vectorized query engine "
                    "(SIGMOD-2018-contest stream protocol on stdin)")
    p.add_argument("--backend", choices=["auto", "dense", "sort"],
                   default="auto", help="equi-join backend")
    p.add_argument("--no-batch", action="store_true",
                   help="execute queries one at a time (debug)")
    p.add_argument("--oracle", action="store_true",
                   help="force the NumPy oracle executor")
    p.add_argument("--reorder-joins", action="store_true",
                   help="enable the stats-driven join-order planner")
    p.add_argument("--no-native", action="store_true",
                   help="disable the C++ host runtime")
    p.add_argument("--profile", action="store_true",
                   help="print per-operator roofline table to stderr")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="execute distributed over an N-device mesh")
    args = p.parse_args()

    config = EngineConfig(
        join_backend=args.backend,
        batch_execution=not args.no_batch,
        force_oracle=args.oracle,
        enable_join_reordering=args.reorder_joins,
        use_native_runtime=not args.no_native,
        profile=args.profile,
        mesh_devices=args.mesh,
    )
    main(config=config)
    if args.profile:
        from .models.engine import _LAST_ENGINE
        if (_LAST_ENGINE is not None
                and _LAST_ENGINE.batch_executor is not None):
            print(_LAST_ENGINE.batch_executor.profiler.report(),
                  file=sys.stderr)


if __name__ == "__main__":
    cli()
