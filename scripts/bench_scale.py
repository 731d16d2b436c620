"""Large-scale synthetic join benchmarks (BASELINE.json configs 4-5).

Generates uniform and Zipf-skewed key columns ON DEVICE (no host transfer)
and measures:
  * single-chip dense-backend probe+expand throughput (join-input tuples/s)
  * distributed skew-aware join throughput over the available mesh
    (on a 1-chip system this still exercises the full shard_map program)

Usage: python scripts/bench_scale.py [--rows 26] [--devices N]
Prints one JSON line per config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def zipf_keys(key, n, n_keys, s=1.1):
    """Approximate Zipf(s) over [0, n_keys) via inverse-CDF on device."""
    import jax, jax.numpy as jnp
    u = jax.random.uniform(key, (n,), minval=1e-9)
    # inverse CDF of a power law: rank ~ u^(-1/(s-1)) truncated
    ranks = jnp.clip((u ** (-1.0 / (s - 1.0))).astype(jnp.int32), 0,
                     n_keys - 1)
    return ranks



def _roofline(bytes_min: int, dt: float) -> dict:
    """BASELINE's per-operator roofline accounting for the huge-node
    passes: bytes_min = the MINIMUM memory traffic of the measured
    program (each full logical pass must read its operand columns
    once; message tables are width-sized, cache-resident), gbps =
    achieved rate against that floor, pct_hbm_peak = how close the
    floor-traffic rate is to the chip's peak. 100% would mean the pass
    streams its operands at speed-of-light with zero overhead (sort
    network passes, gather/scatter engine latency, loop tails all push
    it down). The peak comes from utils/profiling.py's one table."""
    import jax
    from radixhashjoin_tpu.utils.profiling import hbm_bytes_per_s
    kind = jax.devices()[0].device_kind
    peak = hbm_bytes_per_s()
    gbps = bytes_min / dt / 1e9
    return {"bytes_min": int(bytes_min),
            "gbps_min_traffic": round(gbps, 1),
            "pct_hbm_peak": (round(100 * gbps * 1e9 / peak, 2)
                             if peak else None),
            "device_kind": kind}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=26,
                   help="log2 rows per side (default 2^26 = 67M)")
    p.add_argument("--devices", type=int, default=0,
                   help="mesh size (0 = all available)")
    p.add_argument("--skew-rows", type=int, default=1 << 16,
                   help="rows for the skew-aware distributed config")
    p.add_argument("--zipf-engine", action="store_true",
                   help="BASELINE config 4: Zipf(1.1) join + SUM through "
                        "the engine, single chip")
    p.add_argument("--zipf-only", action="store_true",
                   help="skip every other config (implies --zipf-engine) "
                        "so that nothing else holds device memory")
    p.add_argument("--zipf-rows", type=int, default=27,
                   help="log2 fact rows for --zipf-engine (default 134M)")
    p.add_argument("--star-rows", type=int, default=0,
                   help="log2 fact rows for the big STAR join config "
                        "(0 = skip; combine with --zipf-only to keep "
                        "device memory clean at 2^29+)")
    p.add_argument("--chain-rows", type=int, default=0,
                   help="log2 rows for the big CHAIN config (fact1 JOIN "
                        "fact2 JOIN dim, BOTH facts huge — the 2-deep "
                        "huge-chain shape; 0 = skip)")
    p.add_argument("--skew", action="store_true",
                   help="also run the distributed skew-aware config "
                        "(opt-in: the 8-virtual-device CPU tests already "
                        "cover it functionally)")
    args = p.parse_args()

    if args.zipf_only:
        # "only the opt-in big configs": zipf unless a star/chain-only run
        args.zipf_engine = args.zipf_engine or not (args.star_rows
                                                    or args.chain_rows)

    import jax
    import jax.numpy as jnp
    from radixhashjoin_tpu.ops.join_dense import dense_probe
    from radixhashjoin_tpu.parallel import make_mesh, dist_join_skewaware

    n = 1 << args.rows
    n_keys = 1 << 20
    domain = 1 << 21
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)

    from radixhashjoin_tpu.config import EngineConfig
    from radixhashjoin_tpu.models.engine import Engine
    from radixhashjoin_tpu.storage import Relation
    from radixhashjoin_tpu.workload import (FilterPred, JoinPred,
                                            Projection, Query)

    iters = 5
    rng = np.random.default_rng(0)
    if not args.zipf_only:
        # --- config: uniform single-chip probe (counts; the shape-deciding
        # pass of every join) ---
        lv = jax.random.randint(k1, (n,), 0, n_keys, dtype=jnp.int32)
        rv = jax.random.randint(k2, (n,), 0, n_keys, dtype=jnp.int32)
        cnt = jnp.int32(n)
        r = dense_probe(lv, cnt, rv, cnt, domain)   # compile + warm
        total = int(r[4])
        t0 = time.time()
        iters = 5
        for _ in range(iters):
            r = dense_probe(lv, cnt, rv, cnt, domain)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / iters
        print(json.dumps({
            "metric": "dense_probe_uniform_tuples_per_s",
            "rows_per_side": n, "output_pairs": total,
            "value": round(2 * n / dt), "unit": "tuples/s",
            "seconds": round(dt, 4)}))

        # --- config: FK-shaped single-chip join (unique build side: the
        # fact->dimension shape of most production joins) ---
        rv_fk = jax.random.permutation(k3, n_keys).astype(jnp.int32)  # dimension
        rcnt = jnp.int32(n_keys)
        r = dense_probe(lv, cnt, rv_fk, rcnt, domain)   # compile + warm
        total = int(r[4])
        t0 = time.time()
        for _ in range(iters):
            r = dense_probe(lv, cnt, rv_fk, rcnt, domain)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / iters
        print(json.dumps({
            "metric": "dense_probe_fk_tuples_per_s",
            "fact_rows": n, "dim_rows": n_keys, "output_pairs": total,
            "value": round((n + n_keys) / dt), "unit": "tuples/s",
            "seconds": round(dt, 4)}))

        # --- config: NARROW-DOMAIN probe (keys < 4096): the dense backend's
        # table build + double lookup over a 4096-entry table ---
        nd = 1 << 12
        lv_n = jax.random.randint(k1, (n,), 0, nd, dtype=jnp.int32)
        rv_n = jax.random.permutation(k3, nd).astype(jnp.int32)  # unique dim
        rcnt_n = jnp.int32(nd)
        r = dense_probe(lv_n, cnt, rv_n, rcnt_n, nd)   # compile + warm
        total = int(r[4])
        t0 = time.time()
        for _ in range(iters):
            r = dense_probe(lv_n, cnt, rv_n, rcnt_n, nd)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / iters
        print(json.dumps({
            "metric": "dense_probe_narrow_domain_tuples_per_s",
            "fact_rows": n, "dim_rows": nd, "domain": nd,
            "output_pairs": total,
            "value": round((n + nd) / dt), "unit": "tuples/s",
            "seconds": round(dt, 4)}))

        # --- config: star-schema 3-way join through the ENGINE's factorized
        # path (fact JOIN dim1 JOIN dim2, filtered dim, 3 exact u64 SUMs):
        # zero materialization — the 16M-row fact never expands, messages
        # are two dense tables + gathers (ops/factorized.py) ---
        nf = min(n, 1 << 24)               # host->device upload bound
        rng = np.random.default_rng(0)
        fact = Relation([rng.integers(0, n_keys, nf).astype(np.uint64),
                         rng.integers(0, n_keys, nf).astype(np.uint64),
                         rng.integers(0, 1000, nf).astype(np.uint64)])
        dims = [Relation([np.arange(n_keys, dtype=np.uint64),
                          rng.integers(0, 1000, n_keys).astype(np.uint64)])
                for _ in range(2)]
        eng = Engine([fact] + dims, EngineConfig())
        q = Query([0, 1, 2],
                  [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
                  [FilterPred(1, 1, "<", 900)],
                  [Projection(0, 2), Projection(1, 1), Projection(2, 1)])
        eng.run_workload([[q]])            # compile + warm
        t0 = time.time()
        for _ in range(iters):
            out = eng.run_workload([[q]])
        dt = (time.time() - t0) / iters
        print(json.dumps({
            "metric": "star_join_engine_tuples_per_s",
            "fact_rows": nf, "dim_rows": n_keys, "n_joins": 2,
            "factorized": eng.batch_executor.counters["ftree_queries"] > 0,
            "value": round((nf + 2 * n_keys) / dt), "unit": "tuples/s",
            "seconds": round(dt, 4), "sums": out[0][:60]}))

        # --- config: SMALL-DIMENSION star join (1K-row dimensions, the
        # common star-schema shape): per-edge table widths put every message
        # table at <= 1024 bins ---
        nk_small = 1 << 10
        fact_s = Relation([rng.integers(0, nk_small, nf).astype(np.uint64),
                           rng.integers(0, nk_small, nf).astype(np.uint64),
                           rng.integers(0, 1000, nf).astype(np.uint64)])
        dims_s = [Relation([np.arange(nk_small, dtype=np.uint64),
                            rng.integers(0, 1000, nk_small).astype(np.uint64)])
                  for _ in range(2)]
        eng_s = Engine([fact_s] + dims_s, EngineConfig())
        eng_s.run_workload([[q]])          # compile + warm
        t0 = time.time()
        for _ in range(iters):
            out = eng_s.run_workload([[q]])
        dt = (time.time() - t0) / iters
        print(json.dumps({
            "metric": "star_join_smalldim_engine_tuples_per_s",
            "fact_rows": nf, "dim_rows": nk_small, "n_joins": 2,
            "factorized": eng_s.batch_executor.counters["ftree_queries"] > 0,
            "value": round((nf + 2 * nk_small) / dt), "unit": "tuples/s",
            "seconds": round(dt, 4), "sums": out[0][:60]}))

    # --- BASELINE config 4: >= 100M-row Zipf(1.1)-skewed join + exact
    # u64 SUM aggregate THROUGH THE ENGINE, single chip (opt-in: heavy
    # host-side data generation). The single-chip backends are
    # skew-proof by construction (sort/dense-address grouping — no
    # partition can blow up), so no mesh is needed to absorb the skew. ---
    if args.zipf_engine:
        nz = 1 << args.zipf_rows
        s, n_keys_z = 1.1, 1 << 20
        # inverse-CDF power law over [0, n_keys): rank ~ u^(-1/(s-1))
        u = rng.random(nz) + 1e-12
        # clip in float BEFORE the cast (u^-10 overflows int64)
        zk = np.minimum(u ** (-1.0 / (s - 1.0)),
                        n_keys_z - 1).astype(np.uint64)
        top = np.bincount(zk[: 1 << 22].astype(np.int64),
                          minlength=1).max() / min(nz, 1 << 22)
        factz = Relation([zk, rng.integers(0, 1000, nz).astype(np.uint64)])
        dimz = Relation([np.arange(n_keys_z, dtype=np.uint64),
                         rng.integers(0, 1000, n_keys_z).astype(np.uint64)])
        qz = Query([0, 1], [JoinPred(0, 0, 1, 0)],
                   [FilterPred(1, 1, "<", 900)],
                   [Projection(0, 1), Projection(1, 1)])
        # independent exact host oracle (numpy u64, wrapping): dim keys
        # are unique, so fact row r participates iff its key passes the
        # dim filter; SUM(dim.val) weights each passing key by its fact
        # multiplicity
        keep = dimz.values[1] < 900
        wk = keep[zk.astype(np.int64)]
        exp0 = int(factz.values[1][wk].sum(dtype=np.uint64))
        cntz = np.bincount(zk[wk].astype(np.int64),
                           minlength=n_keys_z).astype(np.uint64)
        exp1 = int((dimz.values[1] * cntz * keep).sum(dtype=np.uint64))
        expected = [f"{exp0 % 2**64} {exp1 % 2**64}"]
        # beyond 2^27 rows the materializing path's (2, rows) pair matrix
        # + expansion transients stop fitting one chip's memory: the
        # factorized path (the engine's real path at scale) runs alone,
        # with the host oracle carrying the exactness check
        fact_modes = (True, False) if args.zipf_rows <= 27 else (True,)
        for fact_mode in fact_modes:
            engz = Engine([factz, dimz], EngineConfig(factorized=fact_mode))
            got = engz.run_workload([[qz]])              # compile + warm
            assert got == expected, (got, expected)
            t0 = time.time()
            for _ in range(iters):
                outz = engz.run_workload([[qz]])
            dt = (time.time() - t0) / iters
            # roofline: the factorized query is ONE fused window pass
            # over the fact (gather + A scatter + fold + flag share the
            # loop): key column (4 B) + uint16 value plane (2 B) per
            # row; dim-side work is n_keys-sized (noise at this scale)
            line = {
                "metric": "zipf_join_engine_tuples_per_s",
                "rows": nz, "zipf_s": s, "n_keys": n_keys_z,
                "hot_key_share": round(float(top), 4),
                "factorized": fact_mode,
                # both exactness sources, self-described: the numpy host
                # oracle always asserts; the materializing engine path
                # cross-checks only while its pair matrix fits on the chip
                "oracle_checked": True,
                "cross_checked": len(fact_modes) > 1,
                "value": round((nz + n_keys_z) / dt), "unit": "tuples/s",
                "seconds": round(dt, 4), "sums": outz[0][:60]}
            if fact_mode:
                line.update(fused_passes=1, **_roofline(nz * (4 + 2), dt))
            print(json.dumps(line))

    # --- BASELINE config-4 SHAPE at config-5 SCALE: >= 2^29-row STAR
    # join (fact JOIN dim1 JOIN dim2) + 3 exact u64 SUMs through the
    # engine, single chip (opt-in). The fact node's beta is a lazy
    # PRODUCT of two message gathers, the down-pass A tables build
    # window by window with lazy sibling-product weights, and the
    # projection folds never materialize a fact-length temp
    # (ops/factorized.py:_Lazy / _scatter_add_big). ---
    if args.star_rows:
        ns = 1 << args.star_rows
        n_keys_s = 1 << 20
        u = rng.random(ns) + 1e-12
        zk1 = np.minimum(u ** (-1.0 / 0.1),
                         n_keys_s - 1).astype(np.uint64)   # Zipf(1.1)
        del u
        zk2 = rng.integers(0, n_keys_s, ns).astype(np.uint64)
        fvs = rng.integers(0, 1000, ns).astype(np.uint64)
        d1v = rng.integers(0, 1000, n_keys_s).astype(np.uint64)
        d2v = rng.integers(0, 1000, n_keys_s).astype(np.uint64)
        facts = Relation([zk1, zk2, fvs])
        d1 = Relation([np.arange(n_keys_s, dtype=np.uint64), d1v])
        d2 = Relation([np.arange(n_keys_s, dtype=np.uint64), d2v])
        qs = Query([0, 1, 2],
                   [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
                   [FilterPred(1, 1, "<", 900)],
                   [Projection(0, 2), Projection(1, 1),
                    Projection(2, 1)])
        # independent host oracle (unique dim keys -> direct formulas)
        keep = (d1v < 900)[zk1.astype(np.int64)]
        e0 = int((fvs * keep).sum(dtype=np.uint64)) % 2**64
        e1 = int((d1v[zk1.astype(np.int64)] * keep).sum(dtype=np.uint64)
                 ) % 2**64
        e2 = int((d2v[zk2.astype(np.int64)] * keep).sum(dtype=np.uint64)
                 ) % 2**64
        expected = [f"{e0} {e1} {e2}"]
        engs = Engine([facts, d1, d2], EngineConfig())
        got = engs.run_workload([[qs]])              # compile + warm
        assert got == expected, (got, expected)
        t0 = time.time()
        for _ in range(iters):
            outs = engs.run_workload([[qs]])
        dt = (time.time() - t0) / iters
        # roofline: one fused window pass over the fact serves both A
        # builds, all three folds, and the flag (per-window CSE of the
        # two message gathers): key1 + key2 (4 B each) + uint16 value
        # plane (2 B) per row
        print(json.dumps({
            "metric": "star_join_big_engine_tuples_per_s",
            "rows": ns, "zipf_s": 1.1, "n_keys": n_keys_s, "n_joins": 2,
            "factorized":
                engs.batch_executor.counters["ftree_queries"] > 0,
            "oracle_checked": True,
            "value": round((ns + 2 * n_keys_s) / dt), "unit": "tuples/s",
            "seconds": round(dt, 4), "sums": outs[0][:80],
            "fused_passes": 1, **_roofline(ns * (4 + 4 + 2), dt)}))

    # --- 2-deep HUGE CHAIN: fact1 JOIN fact2 JOIN dim
    # with BOTH facts past the huge threshold. The up pass B-builds
    # over huge fact2 with a lazy gather weight (one window loop), the
    # down pass runs one fused loop per huge node (A build + that
    # node's folds + flag) — 3 window loops total, the
    # message-dependency minimum for a chain (up messages flow
    # bottom-up, down messages top-down: each huge interior node needs
    # one loop per direction; folds ride the down loop for free). ---
    if args.chain_rows:
        nc = 1 << args.chain_rows
        n_keys_c = 1 << 20
        ck1 = rng.integers(0, n_keys_c, nc).astype(np.uint64)
        f1v = rng.integers(0, 1000, nc).astype(np.uint64)
        ck2a = rng.integers(0, n_keys_c, nc).astype(np.uint64)
        ck2b = rng.integers(0, n_keys_c, nc).astype(np.uint64)
        f2v = rng.integers(0, 1000, nc).astype(np.uint64)
        dv = rng.integers(0, 1000, n_keys_c).astype(np.uint64)
        fc1 = Relation([ck1, f1v])
        fc2 = Relation([ck2a, ck2b, f2v])
        dc = Relation([np.arange(n_keys_c, dtype=np.uint64), dv])
        qc = Query([0, 1, 2],
                   [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0)],
                   [FilterPred(2, 1, "<", 900)],
                   [Projection(0, 1), Projection(1, 2),
                    Projection(2, 1)])
        # host oracle via bincount algebra (dim keys unique):
        #   keep[k]   = dim filter on key k
        #   m1[k]     = fact1 rows with key k;  w2[r] = m1[a_r]*keep[b_r]
        U = np.uint64
        keep = (dv < 900).astype(np.uint64)
        m1 = np.bincount(ck1.astype(np.int64),
                         minlength=n_keys_c).astype(U)
        kb = keep[ck2b.astype(np.int64)]
        w2 = m1[ck2a.astype(np.int64)] * kb              # per-f2 weight
        # per-key multiplicity of fact2 rows passing the dim filter
        m2k = np.bincount(ck2a[kb > 0].astype(np.int64),
                          minlength=n_keys_c).astype(U)
        e0 = int((f1v * m2k[ck1.astype(np.int64)]).sum(
            dtype=U)) % 2**64
        e1 = int((f2v * w2).sum(dtype=U)) % 2**64
        m2b = np.bincount(ck2b.astype(np.int64),
                          weights=m1[ck2a.astype(np.int64)].astype(
                              np.float64), minlength=n_keys_c)
        # exact u64 bincount of weights (float64 is exact < 2^53; the
        # per-key weight sums here stay far below that)
        assert m2b.max() < 2**53
        e2 = int((dv * m2b.astype(U) * keep).sum(dtype=U)) % 2**64
        expected = [f"{e0} {e1} {e2}"]
        engc = Engine([fc1, fc2, dc], EngineConfig())
        got = engc.run_workload([[qc]])              # compile + warm
        assert got == expected, (got, expected)
        t0 = time.time()
        for _ in range(iters):
            outc = engc.run_workload([[qc]])
        dt = (time.time() - t0) / iters
        print(json.dumps({
            "metric": "chain_join_big_engine_tuples_per_s",
            "rows_per_fact": nc, "n_keys": n_keys_c, "n_joins": 2,
            "factorized":
                engc.batch_executor.counters["ftree_queries"] > 0,
            "oracle_checked": True,
            "value": round(2 * nc / dt), "unit": "tuples/s",
            "seconds": round(dt, 4), "sums": outc[0][:80],
            # 3 loops: f2 up-B (k1+k2: 8 B), f1 down (k+plane: 6 B),
            # f2 down (k1+k2+plane: 10 B)
            "fused_passes": 3,
            **_roofline(nc * (8 + 6 + 10), dt)}))

    # --- config: Zipf-skewed distributed skew-aware join (opt-in) ---
    if not args.skew:
        return
    n = min(n, args.skew_rows)
    rv = rv[:n]
    ndev = args.devices or len(jax.devices())
    mesh = make_mesh(ndev)
    per = n // ndev
    lz = zipf_keys(k3, n, n_keys)
    counts = jnp.full(ndev, per, dtype=jnp.int32)
    # verify-and-retry capacity sizing (the engine's discipline): double
    # the per-destination exchange capacity until nothing overflows
    capacity = max(2 * per // ndev, 1024)
    while True:
        out = dist_join_skewaware(mesh, lz, counts, rv, counts,
                                  capacity=capacity, heavy_fraction=0.2)
        if int(out[3]) == 0:
            break
        capacity *= 2
    pairs = int(out[0])
    t0 = time.time()
    for _ in range(iters):
        out = dist_join_skewaware(mesh, lz, counts, rv, counts,
                                  capacity=capacity, heavy_fraction=0.2)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / iters
    print(json.dumps({
        "metric": "skewaware_dist_join_tuples_per_s",
        "devices": ndev, "rows_per_side": n, "output_pairs": pairs,
        "overflow": int(out[3]),
        "value": round(2 * n / dt), "unit": "tuples/s",
        "seconds": round(dt, 4)}))


if __name__ == "__main__":
    main()
