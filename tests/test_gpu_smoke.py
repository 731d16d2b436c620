"""The huge-node path at the smallest real size, on a GPU only.

Crosses the real huge-node threshold (ops/factorized.py:_BIG_WAVE_ROWS =
2^28): four full windows plus a ragged tail, against the closed-form
answer. Skips on the CPU; on a GPU:

    RHJ_GPU_TESTS=1 python -m pytest tests/test_gpu_smoke.py -m gpu
"""

import pytest

import chip_smoke
from radixhashjoin_tpu.ops import factorized

pytestmark = pytest.mark.gpu


def test_huge_zipf_join_smoke(gpu_only):
    st = chip_smoke.phase_huge(28, 12345, chip_smoke.CompileClock())
    assert st["huge_path"] and st["rows"] > factorized._BIG_WAVE_ROWS
