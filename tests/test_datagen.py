"""The seeded contest-format generator (radixhashjoin_tpu/datagen.py)."""

import os

import numpy as np
import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.datagen import (N_BATCHES, N_QUERIES, N_RELATIONS,
                                       generate, write_workload)
from radixhashjoin_tpu.models.engine import Engine
from radixhashjoin_tpu.oracle import run_workload
from radixhashjoin_tpu.storage import load_relation
from radixhashjoin_tpu.workload import parse_init_stream, parse_work_stream


def test_same_seed_same_workload():
    a, b = generate(seed=3, scale=0.1), generate(seed=3, scale=0.1)
    assert a.work_text() == b.work_text()
    for ca, cb in zip(a.columns, b.columns):
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x, y)
    assert generate(seed=4, scale=0.1).work_text() != a.work_text()


def test_contest_shape():
    w = generate(seed=0)
    assert len(w.columns) == N_RELATIONS
    assert all(2 <= len(cols) <= 7 for cols in w.columns)
    assert all(1500 <= len(cols[0]) <= 45000 for cols in w.columns)
    assert [len(b) for b in w.batches] == [N_QUERIES // N_BATCHES] * N_BATCHES
    queries = [q for b in w.batches for q in b]
    for q in queries:
        assert 1 <= len(q.joins) <= 3 and len(q.filters) == 1
        assert 1 <= len(q.projections) <= 3
    # every column's keys are unique; all values are narrow
    for cols in w.columns:
        assert len(np.unique(cols[0])) == len(cols[0])
        assert max(int(c.max()) for c in cols) < 2**31
    # a self-join, a parallel edge and a three-slot cycle are present
    assert any(len(set(q.slots)) < len(q.slots) for q in queries)
    pairs = [[frozenset((j.slot1, j.slot2)) for j in q.joins]
             for q in queries]
    assert any(len(set(p)) < len(p) for p in pairs)
    assert any(len(set(p)) == 3 and len(q.slots) == 3
               for p, q in zip(pairs, queries))


def test_files_round_trip(tmp_path):
    w = generate(seed=1, scale=0.05)
    write_workload(w, str(tmp_path), prefix="./")
    with open(tmp_path / "contest.init") as f:
        paths = parse_init_stream(f)
    assert paths == [f"./r{i}" for i in range(N_RELATIONS)]
    for i, cols in enumerate(w.columns):
        rel = load_relation(str(tmp_path / f"r{i}"))
        for got, want in zip(rel.values, cols):
            np.testing.assert_array_equal(np.asarray(got), want)
    with open(tmp_path / "contest.work") as f:
        batches = parse_work_stream(f)
    assert [[q.text for q in b] for b in batches] == \
        [[q.text for q in b] for b in w.batches]


def test_scale_grows_rows_and_domain():
    small, big = generate(seed=0, scale=0.5), generate(seed=0, scale=4)
    for cs, cb in zip(small.columns, big.columns):
        assert len(cb[0]) > 7 * len(cs[0])
    assert max(int(c[0].max()) for c in big.columns) >= 1 << 16


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("config", [
    {},
    {"factorized": False},
    {"join_backend": "sort"},
])
def test_engine_matches_oracle_on_generated_data(seed, config):
    """Executors x seeds on generated contest workloads."""
    w = generate(seed=seed, scale=0.05)
    rels = w.relations()
    want = run_workload(rels, w.batches)
    got = Engine(rels, EngineConfig(**config)).run_workload(w.batches)
    assert got == want


def test_cli_result_file(tmp_path):
    """`python -m radixhashjoin_tpu.datagen --result` writes oracle.py's
    answers beside the workload."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-m", "radixhashjoin_tpu.datagen",
                    "--out", str(tmp_path), "--seed", "2", "--scale",
                    "0.05", "--result"], check=True, cwd=repo,
                   env={"PATH": os.environ["PATH"], "PYTHONPATH": repo,
                        "JAX_PLATFORMS": "cpu"}, timeout=300)
    w = generate(seed=2, scale=0.05)
    with open(tmp_path / "contest.result") as f:
        lines = [line.rstrip("\n") for line in f]
    assert lines == run_workload(w.relations(), w.batches)
