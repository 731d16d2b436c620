"""Native C++ host runtime vs the pure-Python implementations."""

import numpy as np
import pytest

from radixhashjoin_tpu.runtime import (format_results_native,
                                       load_relation_native, native_available,
                                       parse_work_native)
from radixhashjoin_tpu.storage import load_relation
from radixhashjoin_tpu.workload import parse_work_stream

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")

def test_native_loader_matches_python(contest_dir):
    for i in (0, 5, 13):
        py = load_relation(f"{contest_dir}/r{i}")
        nat = load_relation_native(f"{contest_dir}/r{i}")
        assert nat.num_tuples == py.num_tuples
        assert nat.num_columns == py.num_columns
        for c in range(py.num_columns):
            np.testing.assert_array_equal(np.asarray(nat.values[c]),
                                          np.asarray(py.values[c]))
            assert (nat.stats[c].min, nat.stats[c].max,
                    nat.stats[c].distinct) == \
                   (py.stats[c].min, py.stats[c].max, py.stats[c].distinct)


def test_native_parser_matches_python(contest_dir):
    with open(f"{contest_dir}/contest.work") as f:
        text = f.read()
    py = parse_work_stream(text.splitlines(True))
    nat = parse_work_native(text)
    assert len(nat) == len(py)
    for b1, b2 in zip(nat, py):
        assert len(b1) == len(b2)
        for q1, q2 in zip(b1, b2):
            assert q1.slots == q2.slots
            assert q1.joins == q2.joins
            assert q1.filters == q2.filters
            assert q1.projections == q2.projections


def test_native_parser_rejects_garbage():
    with pytest.raises(ValueError):
        parse_work_native("garbage line\n")


def test_native_formatter():
    got = format_results_native(
        [[1, 2], None, [5032407477]], [2, 3, 1])
    assert got == "1 2\nNULL NULL NULL\n5032407477\n"
