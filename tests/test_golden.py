"""Golden end-to-end tests: the reference's only verification artifact
(small.init + small.work -> small.result, SURVEY.md §4) — for BOTH executors.
"""

import pytest

from radixhashjoin_tpu.config import EngineConfig
from radixhashjoin_tpu.models.engine import Engine
from radixhashjoin_tpu.oracle import run_workload


def test_oracle_golden_full(small_catalog, small_batches, golden_lines):
    got = run_workload(small_catalog, small_batches)
    assert got == golden_lines


@pytest.fixture(scope="session")
def jax_engine(small_catalog):
    return Engine(small_catalog, EngineConfig())


@pytest.mark.slow
def test_jax_per_query_golden_batch1(small_catalog, small_batches,
                                     golden_lines):
    eng = Engine(small_catalog, EngineConfig(batch_execution=False))
    got = eng.run_batch(small_batches[0])
    assert got == golden_lines[:len(small_batches[0])]


def test_jax_batched_golden_batch1(jax_engine, small_batches, golden_lines):
    # auto backend => dense (values < 2**18)
    assert jax_engine.batch_executor.join.kind == "dense"
    got = jax_engine.run_batch(small_batches[0])
    assert got == golden_lines[:len(small_batches[0])]


@pytest.mark.slow
def test_jax_sort_backend_golden_batch1(small_catalog, small_batches,
                                        golden_lines):
    eng = Engine(small_catalog, EngineConfig(join_backend="sort"))
    got = eng.run_batch(small_batches[0])
    assert got == golden_lines[:len(small_batches[0])]


def test_jax_stage_group_golden_batch1(small_catalog, small_batches,
                                       golden_lines):
    # grouped fused rounds (stage_group > 1) must stay exact
    eng = Engine(small_catalog, EngineConfig(stage_group=4))
    got = eng.run_batch(small_batches[0])
    assert got == golden_lines[:len(small_batches[0])]


@pytest.mark.slow
def test_jax_golden_full(jax_engine, small_batches, golden_lines):
    got = jax_engine.run_workload(small_batches)
    assert got == golden_lines
