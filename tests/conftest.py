"""Test env: CPU jax with 8 virtual devices, so that the multi-device
sharding logic runs without accelerators (SURVEY.md §4). Must run before
jax is imported.

Tests marked ``gpu`` need a card and skip here (see the ``gpu_only``
fixture); run them on the GPU machine with ``RHJ_GPU_TESTS=1 python -m
pytest tests/ -m gpu``.
"""

import os

_GPU_TESTS = os.environ.get("RHJ_GPU_TESTS") == "1"
if not _GPU_TESTS:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# the generated contest workload every golden test runs (seed 0, scale 1)
# and oracle.py's answers for it, kept as the regression anchor
CONTEST_RESULT = os.path.join(os.path.dirname(__file__), "data",
                              "contest_seed0.result")


@pytest.fixture(scope="session")
def contest_dir(tmp_path_factory):
    """r0..r13 + contest.init/contest.work of the seed-0 workload, written
    in the reference's binary/text formats."""
    from radixhashjoin_tpu.datagen import generate, write_workload
    d = tmp_path_factory.mktemp("contest")
    write_workload(generate(seed=0), str(d), prefix="./")
    return str(d)


@pytest.fixture(scope="session")
def small_catalog(contest_dir):
    from radixhashjoin_tpu.storage import load_relation
    return [load_relation(os.path.join(contest_dir, f"r{i}"))
            for i in range(14)]


@pytest.fixture(scope="session")
def small_batches(contest_dir):
    from radixhashjoin_tpu.workload import parse_work_stream
    with open(os.path.join(contest_dir, "contest.work")) as f:
        return parse_work_stream(f)


@pytest.fixture(scope="session")
def golden_lines():
    with open(CONTEST_RESULT) as f:
        return [line.rstrip("\n") for line in f]


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default device is a GPU. Decided here, at run
    time, so that every xdist worker collects the same tests."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with RHJ_GPU_TESTS=1 on one)")


def make_relation(rng, n, cols, max_val=1 << 18):
    """Synthetic relation in reference value range (SURVEY.md §2.16)."""
    from radixhashjoin_tpu.storage import Relation
    data = [rng.integers(0, max_val, size=n).astype(np.uint64)
            for _ in range(cols)]
    return Relation(data)
