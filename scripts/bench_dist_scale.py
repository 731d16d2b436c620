"""Data-scale distributed validation: the SPMD engine at ~2**22 rows
per chip on an 8-device mesh, with

  * exactness asserted against independent numpy host oracles for BOTH
    engine paths — the d_ftree factorized wave (star join) and the
    exchange pipeline (case-1 all_to_all + d_project's cross-chip
    gathers of global rowids);
  * PER-CHIP memory accounting straight from the compiled programs
    (CompiledMemoryStats: argument/temp/peak bytes are per device), not
    estimates — including the _dist_gather request-matrix shrink from
    the histogram-sized capacity (gcap) vs the worst-case transient.

Runs on the virtual CPU mesh by default (the same programs run on a
multi-GPU host with --devices N):

    python scripts/bench_dist_scale.py [--rows-per-chip 22] [--devices 8]

Prints one JSON line per measurement. Supersedes the reference's
single-node partition scatter (/root/reference/structs.cpp:123-134) at
pod shape: per-chip bytes stay ~1/N of the catalog plus O(shard)
transients.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def _mem_line(tag, lowered, **extra):
    ma = lowered.compile().memory_analysis()
    if ma is None:
        print(json.dumps({"metric": f"dist_mem_{tag}",
                          "error": "memory_analysis unavailable"}))
        return
    print(json.dumps({
        "metric": f"dist_mem_{tag}", "unit": "bytes_per_chip",
        "argument": int(ma.argument_size_in_bytes),
        "output": int(ma.output_size_in_bytes),
        "temp": int(ma.temp_size_in_bytes),
        "peak": int(ma.peak_memory_in_bytes), **extra}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-chip", type=int, default=22,
                    help="log2 fact rows per chip (default 2^22)")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--ftree-only", action="store_true",
                    help="skip the exchange config (its per-chip sort "
                         "temps at 2^27+ rows/chip exceed host RAM on "
                         "the virtual mesh)")
    ap.add_argument("--overfill", action="store_true",
                    help="give each chip 1.25x 2^rows-per-chip REAL "
                         "rows so the per-chip shard slice crosses the "
                         "lazy huge-node threshold (_BIG_WAVE_ROWS) at "
                         "its REAL value — the shard cap buckets to the "
                         "next power of two and the validity mask "
                         "covers the pad)")
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += f" --xla_force_host_platform_device_count={args.devices}"
    # 8 virtual devices oversubscribe this host's cores: a straggling
    # shard thread must not trip the 20/40 s CPU-collective rendezvous
    # kill at data scale (one 2**22-row sort per shard on 4 cores)
    if "collective" not in flags:
        flags += (" --xla_cpu_collective_timeout_seconds=1200"
                  " --xla_cpu_collective_call_terminate_timeout_seconds"
                  "=1200")
    os.environ["XLA_FLAGS"] = flags.strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    jax.config.update("jax_platforms", "cpu")

    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.parallel import DistExecutor, dist_executor
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)

    ndev = args.devices
    per = 1 << args.rows_per_chip
    n = ndev * per * 5 // 4 if args.overfill else ndev * per
    n_keys = 1 << 20
    rng = np.random.default_rng(0)

    # capture each SPMD dispatch's args so the SAME program can be
    # re-lowered for its per-chip memory analysis afterwards
    captured = {}

    def spy(name):
        orig = getattr(dist_executor, name)

        def run(*a, **k):
            captured[name] = (a, k)
            return orig(*a, **k)
        return orig, run

    for nm in ("d_ftree", "d_case1_probe", "d_case1_expand",
               "d_project"):
        orig, run = spy(nm)
        captured[nm + "_orig"] = orig
        setattr(dist_executor, nm, run)

    # ---- config A: star join through the distributed factorized wave
    # (d_ftree) — 2**22 rows/chip fact, two 2**20-row dimensions ----
    k1 = rng.integers(0, n_keys, n).astype(np.uint64)
    k2 = rng.integers(0, n_keys, n).astype(np.uint64)
    fv = rng.integers(0, 1000, n).astype(np.uint64)
    d1v = rng.integers(0, 1000, n_keys).astype(np.uint64)
    d2v = rng.integers(0, 1000, n_keys).astype(np.uint64)
    fact = Relation([k1, k2, fv])
    d1 = Relation([np.arange(n_keys, dtype=np.uint64), d1v])
    d2 = Relation([np.arange(n_keys, dtype=np.uint64), d2v])
    q_star = Query([0, 1, 2],
                   [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
                   [FilterPred(1, 1, "<", 900)],
                   [Projection(0, 2), Projection(1, 1),
                    Projection(2, 1)])
    # independent host oracle (dim keys unique -> direct formulas)
    keep = (d1v < 900)[k1.astype(np.int64)]
    exp = [int((fv * keep).sum(dtype=np.uint64)) % 2**64,
           int((d1v[k1.astype(np.int64)] * keep).sum(dtype=np.uint64))
           % 2**64,
           int((d2v[k2.astype(np.int64)] * keep).sum(dtype=np.uint64))
           % 2**64]
    ex = DistExecutor([fact, d1, d2], EngineConfig(), n_devices=ndev)
    got = ex.run_batch([q_star])
    assert got == [" ".join(str(v) for v in exp)], (got, exp)
    assert ex.counters["ftree_queries"] == 1
    t0 = time.time()
    got = ex.run_batch([q_star])
    dt = time.time() - t0
    cat_bytes = sum(int(np.prod(c.shape)) * c.dtype.itemsize
                    for c in ex.catalog._cols.values())
    print(json.dumps({
        "metric": "dist_star_ftree_tuples_per_s", "devices": ndev,
        "fact_rows": n, "rows_per_chip": per, "dim_rows": n_keys,
        "exact_vs_oracle": True,
        "catalog_bytes_per_chip": cat_bytes // ndev,
        "value": round((n + 2 * n_keys) / dt), "unit": "tuples/s",
        "seconds": round(dt, 3)}))
    a, k = captured["d_ftree"]
    _mem_line("d_ftree_star", captured["d_ftree_orig"].lower(*a, **k),
              rows_per_chip=per, devices=ndev)

    if args.ftree_only:
        return

    # ---- config B: exchange pipeline — case-1 all_to_all join of two
    # 2**22-rows/chip sides (permutation keys: every row matches exactly
    # once), then d_project gathers planes at GLOBAL rowids cross-chip ----
    ka = rng.permutation(n).astype(np.uint64)
    kb = rng.permutation(n).astype(np.uint64)
    av = rng.integers(0, 1000, n).astype(np.uint64)
    bv = rng.integers(0, 1000, n).astype(np.uint64)
    A = Relation([ka, av])
    B = Relation([kb, bv])
    q_x = Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                [Projection(0, 1), Projection(1, 1)])
    expx = [int(av.sum(dtype=np.uint64)) % 2**64,
            int(bv.sum(dtype=np.uint64)) % 2**64]
    # gather_chunks=1 so the capacity bound (not chunking) is what
    # shrinks the request matrix: the memory delta below is pure gcap
    exx = DistExecutor([A, B], EngineConfig(factorized=False,
                                            gather_chunks=1),
                       n_devices=ndev)
    got = exx.run_batch([q_x])
    assert got == [" ".join(str(v) for v in expx)], (got, expx)
    t0 = time.time()
    got = exx.run_batch([q_x])
    dt = time.time() - t0
    print(json.dumps({
        "metric": "dist_exchange_join_tuples_per_s", "devices": ndev,
        "rows_per_side": n, "rows_per_chip": per,
        "exact_vs_oracle": True,
        "gather_retries": exx.counters["gather_retries"],
        "value": round(2 * n / dt), "unit": "tuples/s",
        "seconds": round(dt, 3)}))
    a, k = captured["d_case1_probe"]
    _mem_line("d_case1_probe", captured["d_case1_probe_orig"]
              .lower(*a, **k), rows_per_chip=per, devices=ndev)
    # the expand's pair buffer is count-then-materialize sized: out_cap
    # comes from the probe's measured max total (bucketed), so its
    # per-chip bytes are output-proportional, not worst-case
    a, k = captured["d_case1_expand"]
    _mem_line("d_case1_expand", captured["d_case1_expand_orig"]
              .lower(*a, **k), rows_per_chip=per, devices=ndev,
              out_cap=a[2] if len(a) > 2 else None)
    # the d_project request-matrix shrink: worst-case capacity vs the
    # histogram-sized gcap the executor actually picked
    a, k = captured["d_project"]
    gcap = k.get("gcap", 0)
    _mem_line("d_project_gcap", captured["d_project_orig"]
              .lower(*a, **k), gcap=gcap, rows_per_chip=per)
    k0 = dict(k)
    k0["gcap"] = 0
    _mem_line("d_project_worst_case", captured["d_project_orig"]
              .lower(*a, **k0), gcap=0, rows_per_chip=per)


if __name__ == "__main__":
    main()
