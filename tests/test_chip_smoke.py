"""chip_smoke.py: its refusal without a GPU and its phases at a tiny size.

The phases run here on the CPU; on the card they run at full size
(`python chip_smoke.py`, and `--chips 4` for the four-GPU mesh).
"""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from radixhashjoin_tpu.ops import factorized
from radixhashjoin_tpu.utils import limbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(args, cwd=REPO):
    env = {"JAX_PLATFORMS": "cpu", "PATH": os.environ["PATH"],
           "PYTHONPATH": REPO if cwd == REPO else ""}
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [[], ["--chips", "4"]])
def test_refuses_without_gpu(args):
    r = _smoke(args)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_outside_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    r = _smoke([], cwd=str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_check_gpu_reports_the_cpu_as_refusal():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_gpu()


@pytest.fixture
def huge_thresholds(monkeypatch):
    # cross the huge-node threshold at a test size: window loops + tail
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4 * limbs.WCHUNK)


def test_contest_phase_tiny(tmp_path):
    """Phase (a) at 1/20 of the contest's size: CLI vs oracle, then every
    in-process config vs oracle."""
    w, rels, want, st = chip_smoke.phase_contest_cli(0.05, 0, str(tmp_path))
    assert st["queries"] == 50 and len(want) == 50
    out = chip_smoke.phase_contest_inproc(
        rels, w.batches, want, chip_smoke.CompileClock(),
        configs={"materialized": {"factorized": False}})
    assert set(out["materialized"]) == {"cold_s", "warm_s", "compile_s"}


@pytest.mark.parametrize("mesh", [None, 4])
def test_huge_phase_tiny(huge_thresholds, mesh):
    cfg = {} if mesh is None else {"mesh_devices": mesh}
    st = chip_smoke.phase_huge(13, 77, chip_smoke.CompileClock(), **cfg)
    assert st["huge_path"] and st["rows"] == (1 << 13) + 77


def test_mesh_phase_tiny(huge_thresholds, tmp_path):
    """Phase (c) on four virtual devices at a tiny size."""
    chip_smoke.phase_mesh(chip_smoke.CompileClock(), str(tmp_path),
                          scale=0.05, log_rows=13, tail=77)


def test_zipf_join_expectation_matches_oracle():
    """The closed-form answer of phase (b) equals oracle.py's."""
    from radixhashjoin_tpu.oracle import OracleExecutor, format_result
    rels, q, want = chip_smoke.zipf_join(12, 5, n_keys=1 << 10)
    assert format_result(OracleExecutor(rels).execute(q), 2) == want


def test_compare_reports_mismatch():
    chip_smoke.compare("same", ["1 2", "NULL"], ["1 2", "NULL"])
    with pytest.raises(chip_smoke.SmokeFailure, match="1 of 2"):
        chip_smoke.compare("diff", ["1 2", "3"], ["1 2", "NULL"])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare("short", ["1 2"], ["1 2", "NULL"])
