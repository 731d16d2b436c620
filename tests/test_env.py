"""Process environment: compile-cache placement and the roofline peaks."""

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from radixhashjoin_tpu.utils.profiling import (PEAK_HBM_BYTES_PER_S,
                                               hbm_bytes_per_s)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("jax_first", [False, True])
@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_placement(tmp_path, jax_first, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set, else the checkout's fixed
    .jax_cache, whichever of jax and the package is imported first."""
    imports = ("import jax; import radixhashjoin_tpu" if jax_first
               else "import radixhashjoin_tpu; import jax")
    env = {"PATH": os.environ["PATH"], "PYTHONPATH": REPO,
           "JAX_PLATFORMS": "cpu"}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run(
        [sys.executable, "-c",
         imports + "; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120, check=True)
    assert r.stdout.strip() == want


def test_peak_known_gpu():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert hbm_bytes_per_s(dev) == PEAK_HBM_BYTES_PER_S[dev.device_kind]
    assert hbm_bytes_per_s(dev) == 3.35e12


def test_peak_unknown_accelerator_raises():
    dev = SimpleNamespace(platform="gpu", device_kind="Some Future GPU")
    with pytest.raises(ValueError, match="Some Future GPU"):
        hbm_bytes_per_s(dev)

