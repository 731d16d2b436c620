"""Math/profiling utilities."""

import numpy as np
import pytest

from radixhashjoin_tpu.utils import (OpProfiler, is_prime, next_pow2,
                                     next_prime, pow2)


def test_next_prime():
    # reference behavior (auxFun.cpp:4-22): smallest prime >= n
    assert next_prime(1) == 2
    assert next_prime(2) == 2
    assert next_prime(8) == 11
    assert next_prime(7919) == 7919
    assert next_prime(7920) == 7927


def test_is_prime_edges():
    assert not is_prime(0) and not is_prime(1)
    assert is_prime(2) and is_prime(3) and not is_prime(9)
    assert is_prime(2**31 - 1)   # Mersenne


def test_pow2():
    assert pow2(0) == 1 and pow2(10) == 1024
    assert next_pow2(1) == 1 and next_pow2(1025) == 2048


def test_profiler_report_disabled_is_noop():
    p = OpProfiler(False)
    assert p.record("x", 42, (None,)) == 42
    assert p.report() == "(no ops recorded)"


def test_profiler_counts_input_and_output_bytes():
    import jax.numpy as jnp
    p = OpProfiler(True)
    x = jnp.zeros(1000, jnp.int32)
    out = (jnp.zeros(500, jnp.int32), jnp.zeros((), jnp.int32))
    got = p.record("op", out, (x,))
    assert got is out
    s = p.ops["op"]
    assert s.calls == 1 and s.seconds > 0
    # bytes = input (4000) + result leaves (2000 + 4), exact
    assert s.bytes == 4000 + 2000 + 4
    assert "op" in p.report()


def test_split_merge_fold16_roundtrip_and_psum_width():
    """split_fold16/merge_fold16: exact reconstruction, and the halved
    psum stays exact for MAX_PSUM_CHIPS worth of worst-case folded
    entries (each < 2**26) where a raw int32 psum would overflow."""
    import numpy as np
    import jax.numpy as jnp
    from radixhashjoin_tpu.utils.limbs import (MAX_PSUM_CHIPS, merge_fold16,
                                               split_fold16)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 26, size=(4, 5, 2)).astype(np.int32)
    halves = np.asarray(split_fold16(jnp.asarray(x)))
    assert (merge_fold16(halves) == x).all()
    # worst case: every chip contributes the max folded entry; summing
    # halves in int64 (what merge_fold16 does after an int32 psum of
    # values < 2**16 and < 2**10) must reconstruct the exact total
    worst = (1 << 26) - 1
    n = MAX_PSUM_CHIPS
    lo_sum = np.int64(n) * (worst & 0xFFFF)     # < 2**31: psum-exact
    hi_sum = np.int64(n) * (worst >> 16)        # < 2**25: psum-exact
    assert lo_sum < 2**31 and hi_sum < 2**31
    assert int(lo_sum + (hi_sum << 16)) == n * worst


def test_profiler_roofline_none_on_cpu():
    """On the CPU test backend the roofline column must be absent (no
    hardcoded device constant), not silently wrong."""
    from radixhashjoin_tpu.utils.profiling import OpStats, hbm_bytes_per_s
    assert hbm_bytes_per_s() is None    # tests force the CPU platform
    s = OpStats(calls=1, seconds=1.0, bytes=10**9)
    assert s.roofline_frac is None


def test_seg_chunk_scales_with_rows():
    from radixhashjoin_tpu.utils.limbs import WCHUNK, seg_chunk
    assert seg_chunk(1 << 20, 100) == WCHUNK
    # the 11-bit 3-piece fold is exact to 2**20 chunks: the 2**10 chunk
    # covers 2**30 rows, then the chunk grows, capping at 2**15
    assert seg_chunk((1 << 30) - (1 << 15), 2) == WCHUNK
    assert seg_chunk(1 << 30, 2) == 1 << 11
    assert seg_chunk(1 << 34, 2) == 1 << 15
    with pytest.raises(ValueError):
        seg_chunk(1 << 35, 2)           # loud, never silently wrapping


def test_weighted_segments_exact_at_large_chunks():
    """Regression for the 2**29-row silent carry: the old 13-bit fold
    wrapped a weight-1 carry past 2**18 chunks (observed as a sum short
    by exactly 2**32 on a 537M-row run). The 16-bit-piece fold with
    seg_chunk-sized chunks must be exact at the adversarial envelope:
    16-bit values times 2**31-bound weights (low channels at their
    bounds) and big*big products (the self-healing 2**32-weight
    channels wrapping int32 on purpose)."""
    import jax.numpy as jnp
    from radixhashjoin_tpu.utils.limbs import (
        combine_weighted_segments, weighted_partials_segments)
    rng = np.random.default_rng(12)
    n, chunk = 1 << 22, 1 << 15          # 128 chunks of the max size
    cases = [
        (np.full(n, (1 << 16) - 1, np.int32),
         np.full(n, (1 << 31) - 1, np.int32)),
        (np.full(n, (1 << 31) - 1, np.int32),
         np.full(n, (1 << 31) - 1, np.int32)),
        (rng.integers(0, 1 << 31, n).astype(np.int32),
         rng.integers(0, 1 << 31, n).astype(np.int32)),
    ]
    for vals, cnts in cases:
        fold = weighted_partials_segments(
            jnp.asarray(vals), jnp.asarray(cnts),
            np.asarray([0] * (n // chunk), np.int32), 1, chunk=chunk)
        got = combine_weighted_segments(np.asarray(fold)[0])
        want = int((vals.astype(object) * cnts.astype(object)).sum()
                   ) % 2**64
        assert got == want, (got, want)


def test_weighted_partials_big_matches_oracle(monkeypatch):
    """weighted_partials_big (the no-concat fold for >2**28-row waves:
    windowed fori_loop + clamped final window + masked ragged tail)
    must be exact for every alignment class; the window is shrunk so
    the loop, the idempotent overlap rewrite, and the tail mask all
    execute at test size."""
    import jax.numpy as jnp
    from radixhashjoin_tpu.utils import limbs
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(6)
    chunk = limbs.WCHUNK
    for n in (512,                       # < one chunk: pad-only path
              16 * chunk,                # aligned, exact window multiple
              16 * chunk + 317,          # ragged tail + clamped window
              13 * chunk + chunk // 2):  # ragged, non-window-multiple
        vals = rng.integers(0, 1 << 31, n).astype(np.int32)
        cnts = rng.integers(0, 1 << 31, n).astype(np.int32)
        fold = np.asarray(limbs.weighted_partials_big(
            jnp.asarray(vals), jnp.asarray(cnts)))
        got = limbs.combine_weighted_segments(fold)
        want = int((vals.astype(object) * cnts.astype(object)).sum()
                   ) % 2**64
        assert got == want, (n, got, want)


def test_weighted_partials_big_mask(monkeypatch):
    """weight_mask rows fold to zero, window by window, in both the
    materialized and lazy (table, keys) forms, every alignment class."""
    import jax.numpy as jnp
    from radixhashjoin_tpu.utils import limbs
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)
    rng = np.random.default_rng(9)
    chunk = limbs.WCHUNK
    table = rng.integers(0, 1 << 31, 1 << 12).astype(np.int32)
    for n in (512, 16 * chunk, 16 * chunk + 317, 13 * chunk + chunk // 2):
        vals = rng.integers(0, 1 << 31, n).astype(np.int32)
        keys = rng.integers(0, 1 << 12, n).astype(np.int32)
        mask = rng.random(n) < 0.5
        want = int((vals.astype(object) * table[keys].astype(object)
                    * mask.astype(object)).sum()) % 2**64
        lazy = np.asarray(limbs.weighted_partials_big(
            jnp.asarray(vals), weight_table=jnp.asarray(table),
            weight_keys=jnp.asarray(keys), weight_mask=jnp.asarray(mask)))
        assert limbs.combine_weighted_segments(lazy) == want, n
        mat = np.asarray(limbs.weighted_partials_big(
            jnp.asarray(vals), jnp.asarray(table[keys]),
            weight_mask=jnp.asarray(mask)))
        assert limbs.combine_weighted_segments(mat) == want, n


def test_weighted_partials_big_int32_addressing_guard():
    """Rows past the int32 window-addressing envelope raise loudly
    instead of silently re-folding window 0 (the window start i*w_rows
    wraps negative past 2**31). Checked via eval_shape: no allocation."""
    import jax
    import jax.numpy as jnp
    import pytest
    from radixhashjoin_tpu.ops import factorized
    from radixhashjoin_tpu.utils import limbs
    n_bad = (1 << 31) - (1 << 20)
    spec = jax.ShapeDtypeStruct((n_bad,), jnp.int32)
    with pytest.raises(ValueError, match="int32 window addressing"):
        jax.eval_shape(limbs.weighted_partials_big, spec, spec)
    tbl = jax.ShapeDtypeStruct((64,), jnp.int32)
    with pytest.raises(ValueError, match="int32 window"):
        jax.eval_shape(
            lambda k, t: factorized._lazy_any_positive(
                factorized._Lazy.gather(t, k, 0, False), None), spec, tbl)
    with pytest.raises(ValueError, match="int32 window"):
        jax.eval_shape(
            lambda k, t: factorized._scatter_add_big(
                64, k, 0, None, None, np.int32(64)), spec, tbl)
    # the envelope itself still traces (2**30 = the config-5 target)
    ok = jax.ShapeDtypeStruct((1 << 30,), jnp.int32)
    out = jax.eval_shape(limbs.weighted_partials_big, ok, ok)
    assert out.shape == (5, 3)
