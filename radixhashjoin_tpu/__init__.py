"""radixhashjoin_tpu — a vectorized query-execution engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
engine `pelekoudasq/radixHashJoin` (C++/pthreads, see /root/reference):
an in-memory analytical executor for SPJ-aggregate workloads in the
SIGMOD-2018-contest format (binary columnar uint64 relations; queries of the
form ``tables|predicates|projections``; output = one line of SUM projections
per query).

Design stance (see SURVEY.md §7): we keep the reference's *semantics* —
filters -> ordered pipeline of equi-joins with row-id intermediate chaining ->
SUM projections, validated in SURVEY.md §9 — and none of its *mechanisms*.
Thread pools, paged result lists, chained hash tables and per-pair scans
dissolve into array programs: masks, sorts, scans, gathers, segment ops and
collectives, compiled once per shape-bucket by XLA and scaled over a device
mesh with `shard_map` + `all_to_all`.

Layout:
  storage    — columnar relation loading (np.memmap) + per-column stats
               (reference: structs.cpp:17-84)
  workload   — init/work stream parsing        (reference: Query.cpp:10-63, join.cpp:11-62)
  oracle     — NumPy executor of the validated semantics (test oracle)
  datagen    — seeded contest-format workload generator
  ops        — device operators: filters, expand-join, aggregation, radix,
               factorized message passing
  models     — query executor + (stats-driven) planner
  parallel   — device mesh, distributed radix-exchange join
  runtime    — native (C++) loader/parser bindings, host pipeline
  utils      — padding policy, primes, profiling
"""

from __future__ import annotations

import os

import jax

# Persistent XLA compilation cache: the engine compiles one program per
# (operator, shape-bucket); the cache makes cold starts cheap across
# processes. It lives in $JAX_COMPILATION_CACHE_DIR when that is set, and
# otherwise in the fixed `.jax_cache` of this checkout (a fixed path,
# because the path is part of the cache key). Set through jax.config, so
# it holds whether or not jax was imported before this package.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")
jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR)

from .config import EngineConfig  # noqa: E402
from .storage import Relation, Catalog, load_relation  # noqa: E402
from .workload import Query, parse_work_stream, parse_init_stream  # noqa: E402

__all__ = [
    "EngineConfig",
    "Relation",
    "Catalog",
    "load_relation",
    "Query",
    "parse_work_stream",
    "parse_init_stream",
]

__version__ = "0.1.0"
