"""Engine configuration.

The reference's entire tuning surface is three compile-time macros
(NUM_OF_THREADS=8 JobScheduler.h:11, HASH_LSB=8 Result.cpp:5,
BUCKET_SIZE=128KiB Result.cpp:7). The engine exposes a real config layer:
shape-bucket policy, radix bits, mesh shape, skew thresholds, dtype policy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class EngineConfig:
    # --- shape bucketing (XLA needs static shapes; we pad to buckets) ---
    # Padded sizes are `min_pad * pad_base**k`; coarser base => fewer compiles.
    min_pad: int = 1024
    pad_base: int = 2

    # --- execution override ---
    # Force the NumPy oracle path for everything (debug / wide-value data).
    force_oracle: bool = False
    # Wave-batched breadth-first execution across a query batch (few
    # device->host readbacks per batch); False = one query at a time.
    batch_execution: bool = True
    # Fuse each query into one compiled program per readback boundary
    # (dense backend only); False = one dispatch per operator.
    fuse_stages: bool = True
    # Queries packed into one fused program per round (and per d_ftree
    # wave on a mesh). Grouping is what lets ftree_wave merge message
    # kernels across queries (O(tree height) kernels per round), but
    # XLA's GPU compile time grows faster than the group: on one H100,
    # mesh waves of 1 / 4 / 8 / 16 contest queries compiled in 1.5 /
    # 4.1 / 10.2 / 36.8 s, and the 50-query contest workload took 431 s
    # through the CLI at 64 against 44 s of compile at 4. Warm, 4 ran
    # that workload in 0.0164 s on the H100.
    stage_group: int = 4
    # Defer a middle join's fresh attach when no later join references the
    # attached slot (any depth, any number of slots): rows never expand (a
    # mult row carries the multiplicity) and the readback boundary
    # disappears.
    defer_middle: bool = True
    # Speculative expansion sizing: non-deferable middle joins expand at a
    # stats-estimated padded size INSIDE the same program (no readback); a
    # device flag records mis-speculation and the query retries on the
    # exact readback path. Whole queries become single dispatches.
    speculate_expansions: bool = True
    speculate_slack: float = 4.0        # padding over the estimate
    speculate_max: int = 1 << 22        # never speculate wider than this
    # Factorized execution: a tree-shaped query (every join attaches a
    # fresh slot) runs as count-message passing over the join tree with
    # NO materialization at all (ops/factorized.py) when its exact int32
    # overflow caps hold; cyclic / over-cap queries use the paths above.
    factorized: bool = True
    # Wave batching: merge every factorized query in a round into ONE
    # ftree_wave op whose same-level message scatters/gathers fuse into
    # single segmented-domain kernels across queries — O(tree height)
    # kernels per round instead of O(queries x edges).
    ftree_wave: bool = True
    # Prefer the native (C++) host runtime for loading/parsing when built.
    use_native_runtime: bool = True

    # --- observability ---
    # Per-operator timing + roofline accounting (synchronizes every op:
    # accurate per-op numbers, slower end-to-end).
    profile: bool = False

    # --- radix partitioning (distributed paths) ---
    # Level-0 digits route rows across chips (all_to_all exchange);
    # level-1 digits split per-chip work into partitions.
    radix_bits_global: int = 3      # 2**3 = 8-way cross-chip shuffle by default
    radix_bits_local: int = 8       # 256 per-chip partitions (reference HASH_LSB=8)

    # --- skew handling ---
    # A level-0 digit owning more than this fraction of rows is split and
    # broadcast-joined instead of shuffled (reference has no skew handling).
    skew_heavy_fraction: float = 0.25
    # all_to_all per-destination capacity slack over the uniform share.
    exchange_slack: float = 2.0
    # Case-1 left-side exchange is split into this many sub-exchanges,
    # each probed as soon as it lands: chunk k's searchsorted is
    # independent of chunk k+1's all_to_all, so XLA's latency-hiding
    # scheduler overlaps communication with probe compute (the array
    # analog of the reference's pipelined job queue,
    # /root/reference/JobScheduler.cpp:103-122). Rounded down to a power
    # of two dividing the shard width; 1 disables chunking.
    exchange_chunks: int = 4

    # Sub-gathers per cross-chip _dist_gather: the (n_chips, m) request
    # transient shrinks to (n_chips, m/K) and the K request/response
    # all_to_all chains overlap under async collectives. Skipped below a
    # 4096-lane floor; 1 disables chunking.
    gather_chunks: int = 4

    # Chunks of the case-2 fresh-side broadcast and the case-3 pair-set
    # test: the replicated (n_chips x width) all_gather transient shrinks
    # to (n_chips x width/K) per step (the probe keeps only per-lane
    # counts; the expansion re-gathers chunk by chunk and writes each
    # chunk's matches at running per-lane offsets). 1 disables chunking.
    broadcast_chunks: int = 4

    # Histogram-sized _dist_gather request capacity: per-destination
    # lanes start at ~2x the uniform share (power-of-two, >= 4096)
    # instead of the worst-case chunk length, with verify-and-retry on
    # overflow (DistExecutor._gather_retry) — on a big mesh the
    # request/response all_to_all payload shrinks ~n_chips/2-fold.
    # False pins the worst-case capacity (never overflows, never
    # retries).
    gather_capacity: bool = True

    # --- dtype policy ---
    # Values/rowids ride 32-bit lanes; the file format stays u64
    # at the host boundary (structs.cpp:28-39). Columns with values >= 2**31
    # take the wide (two-plane) path / oracle fallback.
    narrow_dtype: str = "int32"

    # --- aggregation ---
    # SUMs exceed 2**32 (BASELINE.md) => exact u64 via 16-bit limb partial
    # sums; chunk rows so int32 partials cannot overflow: 2**14 * (2**16-1) < 2**30.
    sum_chunk: int = 1 << 14

    # --- planner ---
    # The reference computes filter-selectivity statistics but never consumes
    # them (README.md:62-64 admits join enumeration was never implemented).
    # We keep stats propagation for parity and gate the join-reordering
    # extension behind this flag (off => reference-identical join order).
    enable_join_reordering: bool = False

    # --- execution backend ---
    # "auto"  : dense direct-address join when the catalog's value domain
    #           fits max_dense_domain, else sort+searchsorted
    # "dense" / "sort" : force one backend
    join_backend: str = "auto"
    # Largest value domain for dense direct-address tables (int32 entries:
    # 2**24 -> 64 MB table on device).
    max_dense_domain: int = 1 << 24

    # --- parallelism ---
    # Execute on an n-device mesh (parallel/dist_executor.py): live sets
    # and intermediates row-sharded, case-1 joins via the skew-aware
    # level-0 radix exchange. None => the single-chip executors.
    mesh_devices: Optional[int] = None


DEFAULT = EngineConfig()
