"""Storage layer: binary format contract + stats (reference structs.cpp:17-84)."""

import numpy as np
import pytest

from radixhashjoin_tpu.storage import load_relation, write_relation, Relation


def test_load_small_r0(small_catalog):
    # r0 as written by the seed-0 generator: header and every column
    # survive the binary format unchanged
    from radixhashjoin_tpu.datagen import generate
    want = generate(seed=0).columns[0]
    r0 = small_catalog[0]
    assert r0.num_tuples == len(want[0])
    assert r0.num_columns == len(want)
    for got, col in zip(r0.values, want):
        np.testing.assert_array_equal(np.asarray(got), col)


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, 1 << 18, 100).astype(np.uint64) for _ in range(3)]
    p = str(tmp_path / "rel")
    write_relation(p, cols)
    rel = load_relation(p)
    assert rel.num_tuples == 100 and rel.num_columns == 3
    for a, b in zip(rel.values, cols):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_stats_min_max_distinct():
    col = np.array([5, 5, 7, 3, 3, 3], dtype=np.uint64)
    rel = Relation([col])
    s = rel.stats[0]
    assert (s.min, s.max, s.distinct) == (3, 7, 3)


def test_size_mismatch_rejected(tmp_path):
    p = tmp_path / "bad"
    p.write_bytes(np.array([10, 2, 0], dtype="<u8").tobytes())
    with pytest.raises(AssertionError):
        load_relation(str(p))


def test_narrow_column():
    rel = Relation([np.array([1, 2, 2**31 - 3], dtype=np.uint64)])
    assert rel.fits_narrow
    assert rel.narrow_column(0).dtype == np.int32
